"""Multi-device rendering — screen-band sharding over a torch.distributed group.

The port of the JAX package's parallel/ (there: a jax.sharding.Mesh axis and
shard_map). The screen splits into horizontal bands, one per rank; the scene
and camera are replicated, each rank rasterizes and shades its band, and the
cross-band traffic is the collectives of parallel/collectives.py. The frame
imports the collectives, so ``mesh``'s names load on first use here.
"""

__all__ = ["make_sharded_renderer", "render_frame_sharded", "run_ranks", "shard_temporal"]


def __getattr__(name):
    if name in __all__:
        from androidrenderer_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
