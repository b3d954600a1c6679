# Frozen copy of androidrenderer_tpu_torch/scene/__init__.py at commit c15a27329e0a,
# part of the benchmark's plain reference: imports renamed only.
"""Scene baking: mesh/material pools, procedural fixtures, proxy meshes, SceneArrays."""
