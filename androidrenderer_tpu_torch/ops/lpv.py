"""Light Propagation Volumes — Crytek-style cascaded LPV GI
(gi/light_propagation_volume.cpp:321-1212, shaders/gi/lpv/*). The port of the
JAX package's ops/lpv.py.

- Cascades of R^3 cells (4 x 32^3 in the bench), cell 0.25 m doubling per
  cascade, camera-following with ~10% of the volume behind the camera
  (cpp:455-519), snapped to whole cells.
- A reflective shadow map (RSM: the sun's-eye gbuffer of flux, normal and
  position) per cascade at 128^2 (cpp:548-617): a visibility raster from the sun
  through the Hopper rasterizer (``ops.raster.rasterize``) and a deferred
  resolve through the attribute planes.
- VPL extraction: brightest of each 2x2 RSM quad (rsm_generate_vpls.comp:55-64).
- Injection: cosine-lobe SH x flux scatter-added into the radiance volume; the
  geometry volume (GV) takes surfel occlusion with max-combine (gv_injection).
- Propagation: the 6-neighbour faces scheme with side faces
  (lpv_propagate.comp.slang:36-80) and GV occlusion, ``num_steps`` times.
- Apply: the SH evaluated toward the surface normal from the finest cascade
  holding the point (overlay.frag), scaled by the lpv exposure.

Volumes are (C, 3, 4, R, R, R) tensors, grid order (z, y, x). Injection is one
``index_add_`` and one ``scatter_reduce_("amax")`` over flat (C*R^3 + 1) rows, the
last row the drop row of out-of-volume entries. The scatter-max is exact in
any order; the scatter-add's float sums depend on the order of the adds
(sequential on the CPU, atomics on the card). Propagation shifts a zero-padded
volume and contracts the face terms with two matrix products per step.

The JAX module's single-cascade helpers (``render_rsm``, ``inject``,
``inject_gv_surfels``, ``_rsm_ortho_matrix``) are here with its signatures; the
frame calls none of them, and ``inject`` and ``inject_gv_surfels`` are
``inject_all`` of one cascade.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from androidrenderer_tpu_torch.ops import sh
from androidrenderer_tpu_torch.ops.gbuffer import ATTR_CHANNELS, pack_attribute_planes
from androidrenderer_tpu_torch.ops.post import srgb_to_linear
from androidrenderer_tpu_torch.ops.raster import triangle_setup_corners
from androidrenderer_tpu_torch.ops.shadow import derive_ortho_setup
from androidrenderer_tpu_torch.scene.material_storage import START_ALIGN

# Solid angles of the far face / side faces of a cell as seen from the neighbor
# (standard LPV constants; 6 * (direct + 4 * side) == 4pi).
SA_DIRECT = 0.4006696846
SA_SIDE = 0.4234413544

# Propagation directions, (x, y, z).
_DIRS = np.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    dtype=np.float32,
)


class LPVVolumes(NamedTuple):
    radiance: torch.Tensor  # (C, 3, 4, R, R, R) RGB x SH4, grid order (z, y, x)
    gv: torch.Tensor  # (C, 4, R, R, R) occlusion SH
    mins: torch.Tensor  # (C, 3) world-space min corner
    cell_sizes: torch.Tensor  # (C,) meters


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((v * v).sum(dim=-1))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cascade_origins(
    camera_position: torch.Tensor,  # (3,)
    camera_forward: torch.Tensor,  # (3,)
    num_cascades: int,
    resolution: int,
    base_cell: float,
    behind_percent: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, 3) snapped cascade min corners + (C,) cell sizes (cpp:455-519)."""
    mins = []
    for c in range(num_cascades):
        cell = base_cell * (2.0**c)
        extent = cell * resolution
        center = camera_position + camera_forward * extent * (0.5 - behind_percent)
        mn = center - 0.5 * extent
        mins.append(torch.floor(mn / cell) * cell)  # snap to whole cells
    # base_cell * 2^c, exact in float32, made on the device (no host copy).
    sizes = base_cell * torch.exp2(
        torch.arange(num_cascades, dtype=torch.float32, device=camera_position.device))
    return torch.stack(mins), sizes


def _ortho_from_sphere(center: torch.Tensor, radius, sun_direction: torch.Tensor):
    """World -> light clip ortho covering a bounding sphere (RSM camera).

    All RSM views share the sun basis, so per-cascade matrices differ from any
    canonical one only by scaled rows + translation — exactly the precondition
    of shadow.derive_ortho_setup."""
    eye = torch.eye(4, dtype=torch.float32, device=sun_direction.device)  # no host copy
    sun = sun_direction / _norm(sun_direction)
    up = torch.where(torch.abs(sun[1]) < 0.99, eye[1, :3], eye[0, :3])
    right = torch.linalg.cross(up, sun)
    right = right / _norm(right)
    # right x lup must equal -sun (view-z) or winding mirrors (shadow.fit_cascades).
    lup = torch.linalg.cross(right, sun)
    backup = radius + 1.0
    origin = center - sun * backup
    depth_range = 2.0 * backup
    rowx = right / radius
    rowy = lup / radius
    rowz = -sun / depth_range
    return torch.stack([
        torch.cat([rowx, (-_dot3(rowx, origin)).reshape(1)]),
        torch.cat([rowy, (-_dot3(rowy, origin)).reshape(1)]),
        torch.cat([rowz, (1.0 + _dot3(sun, origin) / depth_range).reshape(1)]),
        eye[3],
    ]).to(torch.float32)


def _rsm_ortho_matrix(cascade_min: torch.Tensor, extent, sun_direction: torch.Tensor):
    """World -> light clip ortho covering a cascade's cube of side ``extent``
    (its RSM camera)."""
    center = cascade_min + 0.5 * extent
    radius = 0.866026 * extent  # bounding sphere of the cube
    return _ortho_from_sphere(center, radius, sun_direction)


def _resolve_rsm(scene, setup, vis: torch.Tensor, use_base_textures: bool = True):
    """RSM deferred resolve: (albedo (R,R,3), normal, world_pos, valid).

    One row gather into the per-triangle attribute-plane table, as the main
    view's resolve (ops/gbuffer.py); the proxy scene (scene/proxy.py::
    swap_in_proxy) carries baked attribute corners and constants, so it resolves
    like a full scene. Flux samples the material's base-color texture at a
    coarse mip like the reference's RSM fragment stage
    (gltf_basic_pbr.slang:240-252)."""
    from androidrenderer_tpu_torch.ops import texture as tex

    valid = vis >= 0
    tid = vis.clamp(min=0).to(torch.int64)
    pl = pack_attribute_planes(scene, setup)[tid]
    nch = pl.shape[-1] // 3
    pa = pl[..., :nch]
    pb = pl[..., nch : 2 * nch]
    pc = pl[..., 2 * nch :]
    dev = vis.device
    px = torch.arange(vis.shape[1], dtype=torch.float32, device=dev)[None, :, None]
    py = torch.arange(vis.shape[0], dtype=torch.float32, device=dev)[:, None, None]
    f = pa * px + pb * py + pc
    s = f[..., ATTR_CHANNELS : ATTR_CHANNELS + 1]
    a = f / torch.where(s == 0.0, torch.ones_like(s), s)
    nrm = a[..., 2:5]
    nrm = nrm / torch.clamp(torch.sqrt((nrm * nrm).sum(dim=-1, keepdim=True)), min=1e-9)
    wpos = a[..., 12:15]
    c0 = ATTR_CHANNELS + 1
    albedo = a[..., c0 : c0 + 3]  # base-color factor (tri_consts channels 0-2)
    if use_base_textures and scene.textures.shape[0] > 0:
        uv = a[..., 0:2]
        packed_t = torch.round(a[..., c0 + 8]).to(torch.int32)  # slot 0 meta
        log2b = packed_t & 15
        start = (packed_t >> 4) * START_ALIGN
        # RSM texels are meters wide: a coarse mip (~16^2) matches the footprint
        # (the reference gets this from hardware derivatives at 128^2).
        level = torch.clamp(log2b - 4, min=0)
        texel = tex.sample_bilinear(scene.textures, start, log2b, uv, level)
        albedo = albedo * srgb_to_linear(texel[..., :3])
    return albedo, nrm, wpos, valid


def render_rsm(
    scene,  # SceneArrays
    matrix: torch.Tensor,  # (4, 4) RSM camera
    resolution: int,
    raster_fn,  # (setup, h, w) -> (depth, vis)
):
    """Render one RSM: (albedo (R,R,3), normal (R,R,3), world_pos (R,R,3), valid);
    every triangle double-sided (the VPL visualizer's, ops/visualize.py)."""
    setup = triangle_setup_corners(
        scene.tri_corner_pos, matrix, resolution, resolution,
        double_sided=torch.ones_like(scene.tri_double_sided), tri_valid=scene.tri_valid,
    )
    _, vis = raster_fn(setup, resolution, resolution)
    return _resolve_rsm(scene, setup, vis)


def _flat_rows(volume: torch.Tensor, ch: int) -> torch.Tensor:
    """(C, ch..., R, R, R) -> (C*R^3 + 1, ch) rows, the last the drop row."""
    c = volume.shape[0]
    rows = volume.reshape(c, ch, -1).transpose(1, 2).reshape(-1, ch)
    return torch.cat([rows, rows.new_zeros((1, ch))])


def _unflat_rows(rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    c, ch = like.shape[0], rows.shape[1]
    return rows[:-1].reshape(c, -1, ch).transpose(1, 2).reshape(like.shape).contiguous()


def inject_all(
    radiance: torch.Tensor,  # (C, 3, 4, R, R, R)
    gv: torch.Tensor,  # (C, 4, R, R, R)
    vpl_parts,  # per cascade: (pos (K,3), normal, flux, mask)
    surfel_parts,  # per cascade: (pos, normal, mask) — RSM texel occluders
    shared_surfels,  # (pos, normal, mask) injected into EVERY cascade, or None
    emissive,  # (pos, normal, flux, mask) into every cascade, or None
    mins: torch.Tensor,  # (C, 3)
    cells: torch.Tensor,  # (C,)
    resolution: int,
):
    """All cascades' VPL/GV injection as ONE scatter-add + ONE scatter-max over
    the flat (C*R^3) row space (each source's cell index offset by its
    cascade); out-of-volume entries go to the drop row. Returns new volumes."""
    c_n = radiance.shape[0]
    r = resolution
    r3 = r**3
    drop = c_n * r3

    def flat_idx(pos, mask, c):
        cell = torch.floor((pos - mins[c]) / cells[c]).to(torch.int64)
        inb = mask & ((cell >= 0) & (cell < r)).all(dim=-1)
        local = (cell[:, 2] * r + cell[:, 1]) * r + cell[:, 0]
        return torch.where(inb, c * r3 + local, torch.full_like(local, drop)), inb

    def occluder(n, inb):
        occ = torch.abs(sh.sh_cosine_lobe(n))
        return torch.where(inb[:, None], occ, torch.zeros_like(occ))

    def radiant(n, flux, inb):
        lobe = sh.sh_cosine_lobe(n)
        contrib = (flux[:, :, None] * lobe[:, None, :]).reshape(-1, 12)
        return torch.where(inb[:, None], contrib, torch.zeros_like(contrib))

    add_idx, add_rows, max_idx, max_rows = [], [], [], []
    for c in range(c_n):
        p, n, flux, mask = vpl_parts[c]
        # Radiance: half-cell normal offset against self-light (vpl bias).
        ai, ainb = flat_idx(p + n * (0.5 * cells[c]), mask, c)
        add_idx.append(ai)
        add_rows.append(radiant(n, flux, ainb))
        # GV occlusion from the VPLs (unbiased position).
        gi, ginb = flat_idx(p, mask, c)
        max_idx.append(gi)
        max_rows.append(occluder(n, ginb))
        sp, sn, sv = surfel_parts[c]
        si, sinb = flat_idx(sp, sv, c)
        max_idx.append(si)
        max_rows.append(occluder(sn, sinb))
        if shared_surfels is not None:
            hp, hn, hv = shared_surfels
            hi, hinb = flat_idx(hp, hv, c)
            max_idx.append(hi)
            max_rows.append(occluder(hn, hinb))
        if emissive is not None:
            ep, en, ef, em = emissive
            ei, einb = flat_idx(ep + en * (0.5 * cells[c]), em, c)
            add_idx.append(ei)
            add_rows.append(radiant(en, ef, einb))
            egi, eginb = flat_idx(ep, em, c)
            max_idx.append(egi)
            max_rows.append(occluder(en, eginb))

    rad_rows = _flat_rows(radiance, 12)
    rad_rows.index_add_(0, torch.cat(add_idx), torch.cat(add_rows))
    gv_rows = _flat_rows(gv, 4)
    idx = torch.cat(max_idx)
    gv_rows.scatter_reduce_(0, idx[:, None].expand(-1, 4), torch.cat(max_rows), "amax")
    return _unflat_rows(rad_rows, radiance), _unflat_rows(gv_rows, gv)


def inject(
    radiance: torch.Tensor,  # (3, 4, R, R, R) one cascade
    gv: torch.Tensor,  # (4, R, R, R)
    vpl_pos: torch.Tensor,  # (K, 3)
    vpl_normal: torch.Tensor,  # (K, 3)
    vpl_flux: torch.Tensor,  # (K, 3)
    vpl_mask: torch.Tensor,  # (K,)
    cascade_min: torch.Tensor,  # (3,)
    cell_size,
    resolution: int,
):
    """One cascade's VPLs scattered into its radiance volume (half a cell along
    the normal) and their occlusion lobes max-combined into its GV: (radiance,
    gv). ``inject_all`` of that one cascade."""
    none = (vpl_pos[:0], vpl_normal[:0], vpl_mask[:0])
    rad, gv = inject_all(radiance[None], gv[None], [(vpl_pos, vpl_normal, vpl_flux, vpl_mask)],
                         [none], None, None, cascade_min[None], _cells(cell_size, gv), resolution)
    return rad[0], gv[0]


def inject_gv_surfels(
    gv: torch.Tensor,  # (4, R, R, R) one cascade's geometry volume
    pos: torch.Tensor,  # (K, 3) surfel positions
    normal: torch.Tensor,  # (K, 3)
    mask: torch.Tensor,  # (K,)
    cascade_min: torch.Tensor,
    cell_size,
    resolution: int,
) -> torch.Tensor:
    """Surfels' occlusion lobes max-combined into one cascade's GV
    (light_propagation_volume.cpp:932-968, 1065-1128). ``inject_all`` of that
    one cascade with no VPL."""
    r = resolution
    none = (pos[:0], normal[:0], pos[:0], mask[:0])
    _, gv = inject_all(gv.new_zeros((1, 3, 4, r, r, r)), gv[None], [none],
                       [(pos, normal, mask)], None, None, cascade_min[None],
                       _cells(cell_size, gv), resolution)
    return gv[0]


def _cells(cell_size, like: torch.Tensor) -> torch.Tensor:
    """A cell size as inject_all's (1,) f32 per-cascade cell sizes."""
    return torch.as_tensor(cell_size, dtype=torch.float32, device=like.device).reshape(1)


def extract_vpls(
    albedo: torch.Tensor,  # (R, R, 3)
    normal: torch.Tensor,
    world_pos: torch.Tensor,
    valid: torch.Tensor,
    sun_color: torch.Tensor,  # (3,)
):
    """Brightest-of-2x2 VPL extraction (rsm_generate_vpls.comp:55-64).

    Returns (pos (K,3), normal (K,3), flux (K,3), mask (K,)) with K = (R/2)^2."""
    r = albedo.shape[0]
    flux = albedo * sun_color[None, None, :] * valid[..., None].to(torch.float32)
    lum = flux[..., 0] * 0.2126 + flux[..., 1] * 0.7152 + flux[..., 2] * 0.0722
    lum4 = lum.reshape(r // 2, 2, r // 2, 2).permute(0, 2, 1, 3).reshape(-1, 4)
    # Deterministic tie-break: a quad of uniform albedo ties exactly, so a 1-ULP
    # shift upstream would flip its pick; a +idx*1e-5-relative nudge dwarfs ULP
    # noise (~1e-7) while any genuine luminance difference (>1e-5 relative)
    # stays in charge. argmax takes the first of equal values, as jnp.argmax.
    tb = lum4.amax(dim=1, keepdim=True) * (
        1e-5 * torch.arange(4, dtype=torch.float32, device=lum.device)
    )
    pick = torch.argmax(lum4 + tb, dim=1)  # (K,)

    def gather(img):
        k = img.shape[-1]
        q = img.reshape(r // 2, 2, r // 2, 2, k).permute(0, 2, 1, 3, 4).reshape(-1, 4, k)
        return torch.gather(q, 1, pick[:, None, None].expand(-1, 1, k))[:, 0]

    v4 = valid.reshape(r // 2, 2, r // 2, 2).permute(0, 2, 1, 3).reshape(-1, 4)
    mask = torch.gather(v4, 1, pick[:, None])[:, 0]
    # Scale: VPL count ratio (32^2 / 128^2) like vpl_injection.frag:36-52.
    scale = (32.0 * 32.0) / (r * r)
    f = gather(flux) * scale
    # HSV saturation x2 (vpl_injection.frag:39-42): the reference's rgb2hsv ->
    # s*=2 -> hsv2rgb round trip reduces to rgb' = 2*rgb - max(rgb).
    f = 2.0 * f - f.amax(dim=-1, keepdim=True)
    return gather(world_pos), gather(normal), f, mask


_FACE_TERMS = {}


def _face_terms(device):
    """Per direction (6), its 5 face terms: the SH evaluated toward the face
    (6, 5, 4), the face's cosine lobe (6, 5, 4) and solid angle / pi (6, 5),
    built in numpy float32 exactly as the reference builds them; then the SH
    toward -d and +d of each direction (6, 4) for the occlusion. Copied to
    ``device`` once."""
    if device in _FACE_TERMS:
        return _FACE_TERMS[device]

    def np_sh_eval(v):
        return np.array([sh.SH_C0, -sh.SH_C1 * v[1], sh.SH_C1 * v[2], -sh.SH_C1 * v[0]],
                        np.float32)

    def np_cos_lobe(v):
        return np.array([sh.COS_LOBE_C0, -sh.COS_LOBE_C1 * v[1], sh.COS_LOBE_C1 * v[2],
                         -sh.COS_LOBE_C1 * v[0]], np.float32)

    evals, lobes, sas = [], [], []
    for d_idx in range(6):
        d = _DIRS[d_idx]
        d_axis = int(np.argmax(np.abs(d)))
        e, l, s = [np_sh_eval(d)], [np_cos_lobe(d)], [SA_DIRECT]
        for s_idx in range(6):
            sdir = _DIRS[s_idx]
            if int(np.argmax(np.abs(sdir))) == d_axis:
                continue
            eval_dir = d + 0.5 * sdir
            eval_dir = eval_dir / np.linalg.norm(eval_dir)
            e.append(np_sh_eval(eval_dir))
            l.append(np_cos_lobe(sdir))
            s.append(SA_SIDE)
        evals.append(e)
        lobes.append(l)
        sas.append(s)
    sa_pi = np.array([[np.float32(s / math.pi) for s in row] for row in sas], np.float32)
    terms = tuple(torch.from_numpy(x).to(device) for x in (
        np.array(evals, np.float32), np.array(lobes, np.float32), sa_pi))
    dirs = torch.from_numpy(_DIRS).to(device)
    _FACE_TERMS[device] = terms + (sh.sh_evaluate(-dirs), sh.sh_evaluate(dirs))
    return _FACE_TERMS[device]


def _neighbors(a: torch.Tensor) -> torch.Tensor:
    """(6, ...) of ``a`` (..., R, R, R): per direction d the value at cell - d
    (the contributing neighbour), zero outside the volume."""
    r = a.shape[-1]
    p = F.pad(a, (1, 1, 1, 1, 1, 1))
    out = []
    for dx, dy, dz in _DIRS.astype(np.int64):
        out.append(p[..., 1 - dz : 1 - dz + r, 1 - dy : 1 - dy + r, 1 - dx : 1 - dx + r])
    return torch.stack(out)


def propagate(
    radiance: torch.Tensor,  # (C, 3, 4, R, R, R)
    gv: torch.Tensor,  # (C, 4, R, R, R)
    num_steps: int,
    occlusion: bool = True,
) -> torch.Tensor:
    """``num_steps`` steps of 6-neighbour propagation with side faces + GV
    occlusion (lpv_propagate.comp.slang:36-80). Returns accumulated radiance.

    Each step shifts the last step's radiance toward all six directions at once
    (slices of one zero-padded copy), evaluates the 30 face terms as one batched
    matrix product, clamps, weights by the direction's occlusion and solid
    angle, and sums into the cosine lobes with a second matrix product."""
    c_n, _, _, r = radiance.shape[:4]
    dev = radiance.device
    evals, lobes, sa_pi, e_neg, e_pos = _face_terms(dev)
    v = r**3
    # GV occlusion per direction is loop-invariant (the GV does not change
    # during propagation). Surfels block flux crossing them from EITHER side
    # (a wall is a wall): evaluate the stored lobe toward both orientations
    # and take the stronger.
    if occlusion:
        ngv = _neighbors(gv).reshape(6, c_n, 4, v)
        amp = torch.maximum(torch.einsum("dk,dckv->dcv", e_neg, ngv),
                             torch.einsum("dk,dckv->dcv", e_pos, ngv))
        occ = 1.0 - torch.clamp(amp, 0.0, 1.0)  # (6, C, V)
    else:
        occ = torch.ones((6, c_n, v), dtype=torch.float32, device=dev)
    weight = occ[:, None, :, None, :] * sa_pi[:, :, None, None, None]  # (6, 5, C, 1, V)

    def step(delta):
        n = _neighbors(delta).reshape(6, c_n, 3, 4, v)
        flux = torch.clamp(torch.einsum("dtk,dcgkv->dtcgv", evals, n), min=0.0) * weight
        return torch.einsum("dtcgv,dtk->cgkv", flux, lobes).reshape(radiance.shape)

    acc = radiance
    delta = radiance
    for _ in range(num_steps):
        delta = step(delta)
        acc = acc + delta
    return acc


def apply_lpv(
    volumes: LPVVolumes,
    world_position: torch.Tensor,  # (H, W, 3)
    normal: torch.Tensor,  # (H, W, 3)
    base_color: torch.Tensor,  # (H, W, 3)
    valid: torch.Tensor,  # (H, W)
    exposure: float,  # lpv exposure cvar (default pi*10)
) -> torch.Tensor:
    """Fullscreen GI overlay (overlay.frag): trilinear SH fetch from the finest
    cascade containing the pixel, evaluated toward the surface normal. The
    eight corner taps of a pixel come from one row gather."""
    c, _, _, r = volumes.radiance.shape[:4]
    h, w, _ = world_position.shape

    # Select the finest cascade containing the point (with a 1-cell margin).
    cellf = (world_position[None] - volumes.mins[:, None, None, :]) / volumes.cell_sizes[
        :, None, None, None
    ]
    inside = ((cellf >= 1.0) & (cellf <= r - 2.0)).all(dim=-1)  # (C, H, W)
    any_inside = inside.any(dim=0)
    ci = torch.zeros((h, w), dtype=torch.int64, device=world_position.device)
    for k in range(c - 1, -1, -1):
        ci = torch.where(inside[k], torch.full_like(ci, k), ci)
    sel = cellf[0]
    for k in range(1, c):
        sel = torch.where((ci == k)[..., None], cellf[k], sel)
    sel = sel - 0.5  # sample at cell centers
    c0 = torch.floor(sel)
    f = sel - c0
    c0i = torch.clamp(c0, 0.0, r - 2.0).to(torch.int64)

    rows = volumes.radiance.permute(0, 3, 4, 5, 1, 2).reshape(c * r**3, 12)
    idx = ((ci * r + c0i[..., 2]) * r + c0i[..., 1]) * r + c0i[..., 0]
    k = torch.arange(8, device=idx.device)
    offs = (k >> 2) * (r * r) + ((k >> 1) & 1) * r + (k & 1)  # dz*R^2 + dy*R + dx
    taps = rows[idx[..., None] + offs]  # (H, W, 8, 12), corner i = dz*4 + dy*2 + dx

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]

    def tap(i):
        return taps[..., i, :]

    v00 = tap(0) + (tap(1) - tap(0)) * fx
    v10 = tap(2) + (tap(3) - tap(2)) * fx
    v01 = tap(4) + (tap(5) - tap(4)) * fx
    v11 = tap(6) + (tap(7) - tap(6)) * fx
    v0 = v00 + (v10 - v00) * fy
    v1 = v01 + (v11 - v01) * fy
    shv = (v0 + (v1 - v0) * fz).reshape(h, w, 3, 4)

    lobe = sh.sh_cosine_lobe(-normal)  # (H, W, 4)
    gi = (
        shv[..., 0] * lobe[..., None, 0]
        + shv[..., 1] * lobe[..., None, 1]
        + shv[..., 2] * lobe[..., None, 2]
        + shv[..., 3] * lobe[..., None, 3]
    )
    gi = torch.clamp(gi, min=0.0)
    gi = gi * base_color * (1.0 / math.pi) * exposure
    return torch.where((valid & any_inside)[..., None], gi, torch.zeros_like(gi))


def _canonical_rsm_setup(scene, mins, cells, resolution: int, rsm_resolution: int):
    """Union sun frame + ONE triangle setup serving every cascade: per-cascade
    RSM setups derive from it by affine coefficient transforms
    (shadow.derive_ortho_setup), which also culls each cascade's raster to the
    triangles inside its footprint (the reference's multiview RSM pass,
    light_propagation_volume.cpp:583-617, gets that from hardware culling).
    Returns (canonical matrix, setup, cascade centers, cascade radii)."""
    extents = cells * resolution
    centers = mins + 0.5 * extents[:, None]
    radii = 0.866026 * extents
    cu = centers.mean(dim=0)
    ru = (_norm(centers - cu) + radii).max()
    m_canon = _ortho_from_sphere(cu, ru, scene.sun_direction)
    # Material sidedness, like the reference's rsm PSOs (material_pipelines.cpp):
    # sun-backfacing single-sided triangles neither make VPLs nor cost raster work.
    setup_rsm = triangle_setup_corners(
        scene.tri_corner_pos, m_canon, rsm_resolution, rsm_resolution,
        double_sided=scene.tri_double_sided, tri_valid=scene.tri_valid,
    )
    return m_canon, setup_rsm, centers, radii


def rsm_setup(scene, setup_rsm, m_canon, center, radius, rsm_resolution: int):
    """The triangle setup of one cascade's RSM, derived from the canonical one."""
    m = _ortho_from_sphere(center, radius, scene.sun_direction)
    return derive_ortho_setup(setup_rsm, m_canon, m, rsm_resolution)


def _rsm_cascade_parts(scene, setup_rsm, m_canon, center, radius, raster_fn,
                       rsm_resolution: int, use_base_textures: bool):
    """One cascade's RSM render -> (vpl_parts, surfel_parts) tuples."""
    setup_i = rsm_setup(scene, setup_rsm, m_canon, center, radius, rsm_resolution)
    _, vis_c = raster_fn(setup_i, rsm_resolution, rsm_resolution)
    albedo, nrm, wpos, val = _resolve_rsm(scene, setup_i, vis_c,
                                          use_base_textures=use_base_textures)
    vpls = extract_vpls(albedo, nrm, wpos, val, scene.sun_color)
    # GV from RSM depth: EVERY sun-visible texel is an occluder surfel
    # (gv_injection path, cpp:932-968) — much denser than the VPL subset.
    surfels = (wpos.reshape(-1, 3), nrm.reshape(-1, 3), val.reshape(-1))
    return vpls, surfels


def _emissive_parts(scene):
    """Emissive mesh-light point clouds (render_scene.cpp:257-310), or None."""
    ep = scene.emissive_points
    if ep.shape[0] <= 1:
        return None
    emask = torch.arange(ep.shape[0], device=ep.device) < scene.emissive_point_count
    return (ep[:, 0:3], ep[:, 3:6], ep[:, 6:9], emask)


def _zeros(n: int, resolution: int, device):
    shape = (resolution,) * 3
    return (torch.zeros((n, 3, 4, *shape), dtype=torch.float32, device=device),
            torch.zeros((n, 4, *shape), dtype=torch.float32, device=device))


def build_lpv(
    scene,
    camera_position: torch.Tensor,
    camera_forward: torch.Tensor,
    raster_fn,
    num_cascades: int,
    resolution: int,
    base_cell: float,
    rsm_resolution: int,
    num_steps: int,
    behind_percent: float = 0.1,
    scene_view_surfels=None,  # (pos (K,3), normal (K,3), valid (K,)) from the gbuffer
    use_base_textures: bool = True,
) -> LPVVolumes:
    """Full LPV frame slice: cascades -> RSM -> VPLs -> inject -> propagate."""
    mins, cells = cascade_origins(camera_position, camera_forward, num_cascades, resolution,
                                  base_cell, behind_percent)
    radiance, gv = _zeros(num_cascades, resolution, camera_position.device)
    m_canon, setup_rsm, centers, radii = _canonical_rsm_setup(
        scene, mins, cells, resolution, rsm_resolution
    )
    vpl_parts, surfel_parts = [], []
    for c in range(num_cascades):
        vpls, surfels = _rsm_cascade_parts(scene, setup_rsm, m_canon, centers[c], radii[c],
                                           raster_fn, rsm_resolution, use_base_textures)
        vpl_parts.append(vpls)
        surfel_parts.append(surfels)
    # Scene-view depth surfels guard against light leaking through sun-shadowed
    # walls (inject_scene_depth_into_gv, cpp:1065-1128).
    radiance, gv = inject_all(radiance, gv, vpl_parts, surfel_parts, scene_view_surfels,
                              _emissive_parts(scene), mins, cells, resolution)
    radiance = propagate(radiance, gv, num_steps)
    return LPVVolumes(radiance=radiance, gv=gv, mins=mins, cell_sizes=cells)


def make_lpv_state(num_cascades: int, resolution: int, device) -> LPVVolumes:
    """Empty cached volumes for the staggered path (TemporalState.lpv). ``mins``
    start at +1e30 so apply_lpv's containment test excludes every pixel from a
    cascade that has never been built — no separate validity mask."""
    radiance, gv = _zeros(num_cascades, resolution, device)
    return LPVVolumes(
        radiance=radiance, gv=gv,
        mins=torch.full((num_cascades, 3), 1e30, dtype=torch.float32, device=device),
        cell_sizes=torch.ones((num_cascades,), dtype=torch.float32, device=device),
    )


def update_lpv_staggered(
    scene,
    camera_position: torch.Tensor,
    camera_forward: torch.Tensor,
    raster_fn,
    state: LPVVolumes,  # cached volumes (make_lpv_state / previous frame)
    frame_index: int,
    num_cascades: int,
    resolution: int,
    base_cell: float,
    rsm_resolution: int,
    num_steps: int,
    behind_percent: float = 0.1,
    scene_view_surfels=None,
    use_base_textures: bool = True,
    update_budget: int = 1,
) -> LPVVolumes:
    """Round-robin cascade updates: rebuild ``update_budget`` cascades this frame
    (RSM -> VPL -> inject -> propagate, from scratch like build_lpv) and keep
    the rest from ``state``; each cached cascade applies with the mins/cell it
    was BUILT with. The cascades updated are picked on the host from the frame
    index. A static scene reaches the every-frame build's steady state after
    ceil(C/B) frames; ``state`` is not modified."""
    b = min(update_budget, num_cascades)
    mins, cells = cascade_origins(camera_position, camera_forward, num_cascades, resolution,
                                  base_cell, behind_percent)
    m_canon, setup_rsm, centers, radii = _canonical_rsm_setup(
        scene, mins, cells, resolution, rsm_resolution
    )
    upd = [(int(frame_index) * b + j) % num_cascades for j in range(b)]
    vpl_parts, surfel_parts = [], []
    for k in upd:
        vpls, surfels = _rsm_cascade_parts(scene, setup_rsm, m_canon, centers[k], radii[k],
                                           raster_fn, rsm_resolution, use_base_textures)
        vpl_parts.append(vpls)
        surfel_parts.append(surfels)
    radiance_b, gv_b = _zeros(b, resolution, camera_position.device)
    radiance_b, gv_b = inject_all(
        radiance_b, gv_b, vpl_parts, surfel_parts, scene_view_surfels, _emissive_parts(scene),
        torch.stack([mins[k] for k in upd]), torch.stack([cells[k] for k in upd]), resolution,
    )
    radiance_b = propagate(radiance_b, gv_b, num_steps)

    rad, gv = state.radiance.clone(), state.gv.clone()
    new_mins, new_cells = state.mins.clone(), state.cell_sizes.clone()
    for j, k in enumerate(upd):
        rad[k] = radiance_b[j]
        gv[k] = gv_b[j]
        new_mins[k] = mins[k]
        new_cells[k] = cells[k]
    return LPVVolumes(radiance=rad, gv=gv, mins=new_mins, cell_sizes=new_cells)
