"""Scene baking: mesh/material pools, procedural fixtures, proxy meshes, SceneArrays."""
