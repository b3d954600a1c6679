"""The bench scene, frozen: the courtyard generator as a record of numpy inputs.

Frozen copy of ``courtyard_scene`` and its mesh and texture helpers from
androidrenderer_tpu_torch/scene/procedural.py at commit c15a27329e0a, so that a
later edit to the program's fixture cannot change the benchmark's workload. The
changes: the scene is a ``SceneRecord`` that records each call (meshes,
textures, materials, primitives, the sun) as numpy arrays and plain values,
and ``Material`` records its arguments. ``SceneRecord.replay(scene_cls,
material_cls)`` makes the same calls on a renderer's own scene builder: the
program's ``RenderScene`` or the reference's frozen copy of it. And
``courtyard_scene``'s materials are a census: ``materials`` gives the number
of textured materials of each kind of surface, each with its own base colour,
normal and metal-rough maps at ``texture_size``, handed out in turn to the
primitives of that kind, where the original had seven materials.
"""

from __future__ import annotations

import numpy as np

ALPHA_MASK = 1
ALPHA_BLEND = 2


class Material:
    """A material's constructor arguments, replayed on a renderer's own class."""

    def __init__(self, *args, **kwargs):
        self.args, self.kwargs = args, kwargs


class _Calls:
    def __init__(self, log, kind):
        self._log, self._kind, self._n = log, kind, 0

    def _add(self, name, *args, **kwargs):
        self._log.append((self._kind, name, args, kwargs))
        self._n += 1
        return self._n - 1


class _Meshes(_Calls):
    def add_mesh(self, *args, **kwargs):
        return self._add("add_mesh", *args, **kwargs)


class _Materials(_Calls):
    def __init__(self, log, kind):
        super().__init__(log, kind)
        self._textures = 0

    def add_texture(self, image):
        self._log.append(("materials", "add_texture", (image,), {}))
        self._textures += 1
        return self._textures - 1  # the texture's place in call order

    def add_material(self, material):
        return self._add("add_material", material)


class SceneRecord:
    """Every call the generator makes, in order, to be replayed on a builder."""

    def __init__(self):
        self.log = []
        self.meshes = _Meshes(self.log, "meshes")
        self.materials = _Materials(self.log, "materials")

    def add_primitive(self, mesh_id, material_id, transform=None):
        self.log.append(("scene", "add_primitive", (mesh_id, material_id, transform), {}))
        return sum(1 for k, n, *_ in self.log if n == "add_primitive") - 1

    def set_sun(self, direction, color, intensity=1.0):
        self.log.append(("scene", "set_sun", (direction, color, intensity), {}))

    @property
    def num_primitives(self) -> int:
        return sum(1 for _, n, *_ in self.log if n == "add_primitive")

    def primitive_meshes(self) -> list:
        """The mesh id of each primitive, in order."""
        return [a[0] for _, n, a, _ in self.log if n == "add_primitive"]

    def replay(self, scene_cls, material_cls):
        """A new ``scene_cls()`` with every recorded call made on it."""
        scene = scene_cls()
        textures = []
        for kind, name, args, kwargs in self.log:
            if name == "add_texture":
                textures.append(scene.materials.add_texture(*args))
            elif name == "add_material":
                m = args[0]
                kw = {k: (textures[v] if k.endswith("_texture") else v)
                      for k, v in m.kwargs.items()}
                scene.materials.add_material(material_cls(*m.args, **kw))
            elif kind == "meshes":
                scene.meshes.add_mesh(*args, **kwargs)
            else:
                getattr(scene, name)(*args, **kwargs)
        return scene


# While it records, ``add_texture`` returns the texture's place in call order;
# the generator only hands such ids on to ``Material``, and replay maps each to
# the id the builder gives it.

def plane_mesh(size_x=1.0, size_z=1.0, subdiv=1, uv_scale=1.0):
    """XZ plane centered at origin, +Y normal. Returns (pos, idx, nrm, uv)."""
    n = subdiv + 1
    xs = np.linspace(-size_x / 2, size_x / 2, n)
    zs = np.linspace(-size_z / 2, size_z / 2, n)
    gx, gz = np.meshgrid(xs, zs, indexing="xy")
    pos = np.stack([gx, np.zeros_like(gx), gz], axis=-1).reshape(-1, 3)
    uv = np.stack(
        [(gx / size_x + 0.5) * uv_scale, (gz / size_z + 0.5) * uv_scale], axis=-1
    ).reshape(-1, 2)
    idx = []
    for r in range(subdiv):
        for c in range(subdiv):
            a = r * n + c
            b = a + 1
            d = a + n
            e = d + 1
            idx += [a, d, b, b, d, e]
    nrm = np.tile([0.0, 1.0, 0.0], (pos.shape[0], 1))
    return (
        pos.astype(np.float32),
        np.array(idx, np.int32),
        nrm.astype(np.float32),
        uv.astype(np.float32),
    )


def box_mesh(sx=1.0, sy=1.0, sz=1.0, subdiv=1):
    """Axis-aligned box centered at origin with per-face normals/uvs."""
    pos, idx, nrm, uv = [], [], [], []
    base = 0
    faces = [
        # (normal, u axis, v axis)
        ([0, 1, 0], [1, 0, 0], [0, 0, 1]),
        ([0, -1, 0], [1, 0, 0], [0, 0, -1]),
        ([1, 0, 0], [0, 0, 1], [0, 1, 0]),
        ([-1, 0, 0], [0, 0, -1], [0, 1, 0]),
        ([0, 0, 1], [1, 0, 0], [0, 1, 0]),
        ([0, 0, -1], [-1, 0, 0], [0, 1, 0]),
    ]
    half = np.array([sx, sy, sz]) / 2
    n = subdiv + 1
    for normal, ua, va in faces:
        normal, ua, va = map(np.asarray, (normal, ua, va))
        us = np.linspace(-1, 1, n)
        vs = np.linspace(-1, 1, n)
        for vv in vs:
            for uu in us:
                p = (normal + ua * uu + va * vv) * half
                pos.append(p)
                nrm.append(normal)
                uv.append([(uu + 1) / 2, (vv + 1) / 2])
        for r in range(subdiv):
            for c in range(subdiv):
                a = base + r * n + c
                b, d, e = a + 1, a + n, a + n + 1
                idx += [a, d, b, b, d, e]
        base += n * n
    return (
        np.array(pos, np.float32),
        np.array(idx, np.int32),
        np.array(nrm, np.float32),
        np.array(uv, np.float32),
    )


def cylinder_mesh(radius=0.5, height=2.0, segments=16, stacks=4):
    """Open-ended vertical cylinder centered at origin."""
    pos, nrm, uv, idx = [], [], [], []
    for s in range(stacks + 1):
        y = height * (s / stacks - 0.5)
        for a in range(segments + 1):
            ang = 2 * np.pi * a / segments
            c, sn = np.cos(ang), np.sin(ang)
            pos.append([radius * c, y, radius * sn])
            nrm.append([c, 0.0, sn])
            uv.append([a / segments * 4.0, s / stacks])
    w = segments + 1
    for s in range(stacks):
        for a in range(segments):
            i0 = s * w + a
            i1, i2, i3 = i0 + 1, i0 + w, i0 + w + 1
            idx += [i0, i2, i1, i1, i2, i3]
    return (
        np.array(pos, np.float32),
        np.array(idx, np.int32),
        np.array(nrm, np.float32),
        np.array(uv, np.float32),
    )


def translate(t):
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = t
    return m


def transform(t=(0, 0, 0), scale=(1, 1, 1), ry=0.0):
    c, s = np.cos(ry), np.sin(ry)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = (rot * np.asarray(scale)).astype(np.float32)
    m[:3, 3] = t
    return m


# ----------------------------------------------------------------------- textures


def checker_texture(size=64, tiles=8, c0=(255, 255, 255), c1=(40, 40, 40)):
    y, x = np.mgrid[0:size, 0:size]
    mask = ((x * tiles // size) + (y * tiles // size)) % 2 == 0
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 3] = 255
    img[mask, :3] = c0
    img[~mask, :3] = c1
    return img


def noise_texture(size=64, seed=0, base=(180, 140, 100), amp=40):
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 4), np.uint8)
    noise = rng.integers(-amp, amp, (size, size, 1))
    img[..., :3] = np.clip(np.asarray(base) + noise, 0, 255)
    img[..., 3] = 255
    return img


def mr_texture(size=64, seed=6):
    """Metallic-roughness texture (G=roughness, B=metalness — the glTF/gbuffer
    channel convention): banded roughness with sparse metallic flecks."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rough = 0.55 + 0.4 * np.sin(x * 21.0) * np.sin(y * 13.0)
    metal = (rng.uniform(0, 1, (size, size)) > 0.92).astype(np.float32)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = np.clip(rough * 255.0, 0, 255).astype(np.uint8)
    img[..., 2] = (metal * 255).astype(np.uint8)
    img[..., 3] = 255
    return img


def foliage_alpha_texture(size=64, seed=1):
    """Blotchy alpha texture for alpha-mask testing (AlphaTest.gltf analog)."""
    rng = np.random.default_rng(seed)
    img = np.zeros((size, size, 4), np.uint8)
    img[..., 1] = 140
    img[..., 0] = 40
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    a = np.zeros((size, size))
    for _ in range(12):
        cx, cy, r = rng.uniform(0, 1, 3)
        a += np.exp(-(((x - cx) ** 2 + (y - cy) ** 2) / (0.02 * (r + 0.2) ** 2)))
    img[..., 3] = (np.clip(a, 0, 1) > 0.35) * 255
    return img



SURFACES = ("floor", "wall", "column", "capital", "drape", "foliage", "curtain")


def courtyard_scene(column_rings: int, detail: int, curtains: bool, texture_size: int,
                    materials: dict) -> "SceneRecord":
    """Sponza-scale colonnade courtyard stress scene.

    detail=3, column_rings=3 is ~30k tris; detail scales quadratically:
    ``courtyard_scene(column_rings=4, detail=12, curtains=True)`` has 275,328
    triangles in 135 primitives, Crytek Sponza's 262,267 within 5%. Camera:
    stand at (0, 1.7, 6) looking at the origin.

    ``materials`` ({kind: count}, kinds ``SURFACES``) gives each kind of
    surface that many textured materials, each with its own base colour,
    normal and metal-rough maps of ``texture_size`` texels a side, handed out
    in turn to the primitives of that kind (``_census``).
    """
    scene = SceneRecord()
    ms, mats = scene.meshes, scene.materials
    pick = _census(mats, texture_size, materials, curtains)

    sub = max(2, detail * 2)
    fp, fi, fn, fu = plane_mesh(24.0, 16.0, subdiv=sub * 2, uv_scale=8.0)
    floor = ms.add_mesh(fp, fi, fn, uvs=fu)
    wp, wi, wn, wu = box_mesh(24.0, 8.0, 0.5, subdiv=sub)
    long_wall = ms.add_mesh(wp, wi, wn, uvs=wu)
    wp, wi, wn, wu = box_mesh(0.5, 8.0, 16.0, subdiv=sub)
    short_wall = ms.add_mesh(wp, wi, wn, uvs=wu)
    cp, ci, cn, cu = cylinder_mesh(0.35, 5.0, segments=8 * detail, stacks=2 * detail)
    column = ms.add_mesh(cp, ci, cn, uvs=cu)
    bp, bi, bn, bu = box_mesh(1.0, 0.3, 1.0, subdiv=max(1, detail // 2))
    capital = ms.add_mesh(bp, bi, bn, uvs=bu)
    dp, di, dn, du = plane_mesh(2.5, 3.5, subdiv=sub)
    drape = ms.add_mesh(dp, di, dn, uvs=du)
    hp_, hi_, hn_, hu_ = plane_mesh(2.4, 1.6, subdiv=sub)
    hedge = ms.add_mesh(hp_, hi_, hn_, uvs=hu_)
    sp, si, sn_, su = box_mesh(0.8, 0.8, 0.8, subdiv=detail)
    ornament = ms.add_mesh(sp, si, sn_, uvs=su)

    scene.add_primitive(floor, pick("floor"))
    scene.add_primitive(long_wall, pick("wall"), translate([0, 4.0, -8.0]))
    scene.add_primitive(long_wall, pick("wall"), translate([0, 4.0, 8.0]))
    scene.add_primitive(short_wall, pick("wall"), translate([-12.0, 4.0, 0]))
    scene.add_primitive(short_wall, pick("wall"), translate([12.0, 4.0, 0]))

    def rot_x90():
        m = np.eye(4, dtype=np.float32)
        m[1, 1], m[1, 2] = 0.0, -1.0
        m[2, 1], m[2, 2] = 1.0, 0.0
        return m

    rng = np.random.default_rng(42)
    for ring in range(column_rings):
        z = -6.0 + ring * (12.0 / max(column_rings - 1, 1))
        for k in range(8):
            x = -10.5 + k * 3.0
            scene.add_primitive(column, pick("column"), translate([x, 2.5, z]))
            scene.add_primitive(capital, pick("capital"), translate([x, 5.15, z]))
            if k % 2 == 0:
                scene.add_primitive(
                    drape, pick("drape"), transform((x + 1.5, 3.5, z), ry=0.0) @ rot_x90()
                )
            else:
                # Alpha-masked hedge between columns (Sponza's plant pots):
                # ~12% of scene triangles end up MASK-mode at bench detail.
                scene.add_primitive(
                    hedge, pick("foliage"),
                    transform((x + 1.5, 0.8, z), ry=0.0) @ rot_x90(),
                )
    for _ in range(10):
        x, z = rng.uniform(-9, 9), rng.uniform(-5, 5)
        scene.add_primitive(
            ornament, pick("gold"), transform((x, 0.4, z), ry=rng.uniform(0, 3.14))
        )
    # Ivy rows along the long walls — pushes the masked share to ~13% of
    # triangles (Sponza's alpha-tested plant fraction).
    for k in range(8):
        x = -10.5 + k * 3.0
        for z in (-7.4, 7.4):
            scene.add_primitive(
                hedge, pick("foliage"), transform((x, 0.8, z), ry=0.0) @ rot_x90()
            )

    # Translucent curtains (ALPHA_BLEND) — Sponza hangs blend-mode curtains at
    # ~3% of its triangles (render_scene.cpp:57-69 classification); without
    # them the headline frame never exercises the peel composite at bench
    # scale. Opt-in so feature-pinned fixtures keep their exact content.
    if curtains:
        for k in range(4):
            x = -7.5 + k * 6.0
            scene.add_primitive(
                drape, pick("curtain"), transform((x, 3.2, 1.0), ry=0.0) @ rot_x90()
            )
            scene.add_primitive(
                drape, pick("curtain"), transform((x + 1.2, 3.2, -3.0), ry=0.0) @ rot_x90()
            )

    scene.set_sun([0.35, -1.0, 0.25], [1.0, 0.96, 0.88], 110_000.0)
    return scene


# Each kind's base colour map (two colours, or a colour and its noise) and
# material settings; a kind's materials differ by the seed of their maps and a
# tint. The opaque kinds, the alpha-tested foliage (ALPHA_MASK) and the
# translucent curtains (ALPHA_BLEND) are the shares of Sponza's census.
_KINDS = {
    "floor": dict(colors=((200, 190, 170), (90, 80, 70)), checker=16, roughness=0.8),
    "wall": dict(colors=((190, 160, 130),), noise=25, roughness=0.9),
    "column": dict(colors=((210, 200, 185),), noise=15, roughness=0.6),
    "capital": dict(colors=((200, 185, 160),), noise=20, roughness=0.7),
    "drape": dict(colors=((160, 30, 30), (120, 15, 15)), checker=4, roughness=0.95,
                  double_sided=True),
    "foliage": dict(colors=None, roughness=1.0, double_sided=True, alpha_mode=ALPHA_MASK),
    "curtain": dict(colors=((60, 90, 160), (40, 60, 120)), checker=8, roughness=0.9,
                    double_sided=True, alpha_mode=ALPHA_BLEND, alpha=0.45),
}


def _census(mats, size: int, counts: dict, curtains: bool):
    """``counts[kind]`` textured materials per kind of surface, each with its
    own base colour, normal and metal-rough maps of ``size`` texels a side:
    ``pick(kind)`` hands them out in turn. The normal and metal-rough maps
    are each made once and rolled by a different offset for each material."""
    if size is None or set(counts) != set(SURFACES):
        raise ValueError(f"materials need a texture_size and a count for each of {SURFACES}")
    rng = np.random.default_rng(5)
    h = rng.normal(0, 1, (size, size)).astype(np.float32)
    for _ in range(3):  # cheap separable blur -> smooth bumps
        h = (h + np.roll(h, 1, 0) + np.roll(h, -1, 0)
             + np.roll(h, 1, 1) + np.roll(h, -1, 1)) / 5.0
    nrm0, mr0 = _normal_map(h, 2.5), mr_texture(size, 6)
    lists = {}
    n = 0
    for kind in SURFACES:
        if kind == "curtain" and not curtains:
            continue
        spec = _KINDS[kind]
        lists[kind] = []
        for v in range(counts[kind]):
            n += 1
            tint = 1.0 - 0.08 * v
            if spec["colors"] is None:
                base = foliage_alpha_texture(size, 7 + n)
            elif "checker" in spec:
                c0, c1 = (tuple(int(c * tint) for c in col) for col in spec["colors"])
                base = checker_texture(size, spec["checker"] * (1 + v % 2), c0, c1)
            else:
                c0 = tuple(int(c * tint) for c in spec["colors"][0])
                base = noise_texture(size, 100 + n, c0, spec["noise"])
            shift = (size * n) // 7
            nrm = np.roll(nrm0, (shift, 3 * shift), (0, 1))
            mr = np.roll(mr0, (3 * shift, shift), (0, 1))
            ids = [mats.add_texture(t) for t in (base, nrm, mr)]
            factor = np.ones(4, np.float32)
            factor[3] = spec.get("alpha", 1.0)
            lists[kind].append(mats.add_material(Material(
                factor, base_color_texture=ids[0], normal_texture=ids[1],
                metal_rough_texture=ids[2], roughness_factor=spec["roughness"],
                double_sided=spec.get("double_sided", False),
                **({"alpha_mode": spec["alpha_mode"], "alpha_cutoff": 0.5}
                   if "alpha_mode" in spec else {}))))
    lists["gold"] = [_gold(mats)]
    turn = {kind: 0 for kind in lists}

    def pick(kind):
        i = turn[kind]
        turn[kind] += 1
        return lists[kind][i % len(lists[kind])]

    return pick


def _gold(mats) -> int:
    """The untextured metal of the ornaments."""
    return mats.add_material(
        Material(
            np.array([1.0, 0.77, 0.34, 1.0], np.float32),
            metalness_factor=1.0,
            roughness_factor=0.3,
        )
    )


def _normal_map(h: np.ndarray, strength: float) -> np.ndarray:
    """Tangent-space normal map (u8 RGBA) of height field ``h``."""
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * strength
    dy = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * strength
    n = np.stack([-dx, -dy, np.ones_like(h)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    img = np.zeros(h.shape + (4,), np.uint8)
    img[..., :3] = np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    img[..., 3] = 255
    return img
