"""What the program and the reference share of a cell: the frame's settings and
the scene's inputs, each made by the benchmark and handed to both sides."""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from benchmark.harness.walk import Walk
from benchmark.reference.courtyard import courtyard_scene


def make_config(config_module, cfg: dict):
    """The RenderConfig of configuration ``cfg`` in ``config_module`` (the
    program's ``config`` or the reference's copy): ``cfg["frame"]`` names the
    preset, ``cfg["render_config"]`` gives its width, height and the fields it
    sets (enums by member name, tuples as lists)."""
    rc = dict(cfg["render_config"])
    width, height = rc.pop("width"), rc.pop("height")
    fields = {f.name: f for f in dataclasses.fields(config_module.RenderConfig)}
    kw = {}
    for key, value in rc.items():
        default = fields[key].default
        if isinstance(default, enum.Enum):
            value = type(default)[value]
        elif isinstance(default, tuple):
            value = tuple(value)
        kw[key] = value
    return getattr(config_module, cfg["frame"])(width, height, **kw)


def scene_record(cfg: dict):
    """The frozen generator's record of the configuration's scene."""
    scene = cfg["scene"]
    if scene["generator"] != "courtyard":
        raise ValueError(f"unknown scene generator {scene['generator']!r}")
    return courtyard_scene(**scene["args"])


def rest_transforms(record) -> np.ndarray:
    """(P, 4, 4) f32: each recorded primitive's transform as built."""
    out = []
    for _, name, args, _ in record.log:
        if name == "add_primitive":
            t = args[2]
            out.append(np.eye(4, dtype=np.float32) if t is None else np.asarray(t, np.float32))
    return np.stack(out)


def make_walk(cfg: dict, traffic: dict, seed: int, record) -> Walk:
    """The walk of configuration ``cfg`` under ``traffic``: its camera takes
    the output size and the render size of the configuration's RenderConfig
    (the reference's copy), and the TAA jitter where ``aa_mode`` is TAA."""
    from benchmark.reference.plain import config as ref_config

    rc = make_config(ref_config, cfg)
    cam = cfg["camera"]
    return Walk(traffic, seed, rc.output_width, rc.output_height, cam["fov_degrees"],
                cam["z_near"], record.primitive_meshes(), rest_transforms(record),
                render_size=(rc.render_width, rc.render_height),
                jitter=rc.aa_mode == ref_config.AAMode.TAA)
