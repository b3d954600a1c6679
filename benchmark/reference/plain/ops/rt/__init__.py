# Frozen copy of androidrenderer_tpu_torch/ops/rt/__init__.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Ray tracing over the preorder skip-link BVH: traversal (a hand CUDA kernel and
its plain version) and the effects built on it (RT sun shadows, RTAO)."""
