"""Frame stages: culling, raster, gbuffer resolve, shadows, sky, lighting, post."""
