# Frozen copy of androidrenderer_tpu_torch/ops/__init__.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Frame stages: culling, raster, gbuffer resolve, shadows, sky, lighting, post."""
