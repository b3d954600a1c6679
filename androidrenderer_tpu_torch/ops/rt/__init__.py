"""Ray tracing over the preorder skip-link BVH: traversal (a hand CUDA kernel and
its plain version) and the effects built on it (RT sun shadows, RTAO)."""
