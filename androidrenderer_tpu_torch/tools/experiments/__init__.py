"""The port's entry points of the raster design studies in tools/experiments/:
``rasterize_touch`` (touch expansion), ``rasterize_lanes`` (8-touch sublane
fold) and ``rasterize_subfold`` (win32 tables, win8 folds). Each was a TPU
schedule of the raster family's contract; on Hopper each launches the one
hand-written raster kernel (csrc/raster.cu) and counts its own launches."""
