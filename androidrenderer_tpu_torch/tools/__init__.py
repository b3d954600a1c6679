"""The port's counterparts of the repository's tools/: the gather microbench
(``microbench_pallas_gather``), the raster microbench (``bench_raster``) and the
raster design studies it can run (``experiments``). Run the two microbenches with
``python -m`` from the repository root; they use the card unless given
``--device cpu``."""
