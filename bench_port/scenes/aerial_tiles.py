"""An airborne LiDAR survey in square tiles, as LAS 1.4 files hold it.

Input ``index`` is tile ``index`` of the project's ``tiles`` grid in
row-major order: ground on rolling terrain, buildings (roofs and wall
returns) and tree crowns whose pulses add further returns, coloured from
an orthophoto at each return's position and quantised to ``las_scale``.
"""

from __future__ import annotations

import numpy as np

from ..gen import Draws, rng_for

# The CPU tests' cut: tiles of 60 m at 4 pulses a square metre, with a
# few buildings and trees, so a 2 x 2 block renders and converts in
# seconds there; every other size, and the store settings, stay.
SMALL = {"tile_m": 60.0, "pulses_per_m2": 4.0, "buildings_per_tile": 3,
         "trees_per_tile": 15}


def fields(scene: dict, seed: int, index: int, device="cpu") -> dict:
    """Tile ``index`` drawn on ``device``: the fields its LAS file holds."""
    raw, rgb, ret, cls = aerial_tile(scene, seed, index, device)
    return {"raw": raw, "rgb": rgb, "returns": ret, "classes": cls}


def decoded(scene: dict, fields: dict):
    """(positions f32, colours rgba u8) as the port's LAS reader decodes
    the tile's file."""
    return (las_positions(fields["raw"], scene["las_scale"]),
            las_colors(fields["rgb"]))


def points(scene: dict) -> int:
    g, b, _, v = aerial_counts(scene)
    return g + b + v


def small(scene: dict) -> dict:
    return dict(scene, **SMALL)


def _terrain(scene: dict, seed: int):
    """Ground height of the whole project: a few smooth waves over a base,
    as a function of (x, y) tensors."""
    rng = rng_for(seed, 0)
    waves = scene["terrain_waves"]
    amp = rng.uniform(0.3, 1.0, waves) * scene["terrain_relief_m"] / waves
    length = rng.uniform(0.25, 1.0, waves) * scene["terrain_wavelength_m"]
    angle = rng.uniform(0, 2 * np.pi, waves)
    phase = rng.uniform(0, 2 * np.pi, waves)
    kx = 2 * np.pi / length * np.cos(angle)
    ky = 2 * np.pi / length * np.sin(angle)
    base = float(scene["terrain_base_m"])

    def height(x, y):
        z = x * 0.0 + base
        for i in range(waves):
            z = z + float(amp[i]) * (float(kx[i]) * x + float(ky[i]) * y
                                     + float(phase[i])).sin()
        return z

    return height


def _ortho(x, y, gsd: float, seed: int):
    """(N, 3) u8 orthophoto colour at each position: a hashed pixel over a
    smooth field, so equal positions get equal colours."""
    import torch

    px = torch.floor(x / gsd).to(torch.int64)
    py = torch.floor(y / gsd).to(torch.int64)
    h = (px * 73856093) ^ (py * 19349663) ^ (seed & 0xFFFFFFF)
    h = (h ^ (h >> 13)) * 0x5BD1E995
    h = (h ^ (h >> 15)) & 0xFFFFFF
    smooth = 0.5 + 0.25 * ((x / 37.0).sin() + (y / 53.0).cos())
    out = []
    for c, shift in enumerate((0, 8, 16)):
        grain = ((h >> shift) & 0xFF).to(torch.float64) / 255.0
        out.append(((0.35 + 0.3 * c / 2) * 255 * smooth + 60 * grain)
                   .clamp(0, 255).to(torch.uint8))
    return torch.stack(out, dim=1)


def aerial_tile(scene: dict, seed: int, tile: int, device="cpu"):
    """One tile of the project in row-major order, as LAS fields:
    (raw (N, 3) i32, rgb (N, 3) u8, returns (N,) u8, classes (N,) u8)."""
    import torch

    cols, rows = scene["tiles"]
    side = float(scene["tile_m"])
    x0 = (tile % cols - cols / 2) * side
    y0 = (tile // cols - rows / 2) * side
    n_gnd, n_bld, n_pulse_veg, n_veg = aerial_counts(scene)
    n = n_gnd + n_bld + n_veg
    lay = rng_for(seed, 1, tile)
    d = Draws(seed, (2, tile), device)
    height = _terrain(scene, seed)

    def full(v, k):
        return torch.full((k,), v, dtype=torch.uint8, device=device)

    xs, ys, zs, ret, cls = [], [], [], [], []
    # ground
    x, y = d.uniform(x0, x0 + side, n_gnd), d.uniform(y0, y0 + side, n_gnd)
    xs.append(x), ys.append(y), zs.append(height(x, y) + d.normal(0.05, n_gnd))
    ret.append(full(0x11, n_gnd)), cls.append(full(2, n_gnd))
    # buildings: flat roofs and some wall returns, by footprint area
    nb = scene["buildings_per_tile"]
    margin = min(30.0, side / 4)
    cx = lay.uniform(x0 + margin, x0 + side - margin, nb)
    cy = lay.uniform(y0 + margin, y0 + side - margin, nb)
    w, dep = lay.uniform(8, 40, nb), lay.uniform(8, 40, nb)
    top = height(torch.as_tensor(cx), torch.as_tensor(cy)).numpy() \
        + lay.uniform(4, 30, nb)
    which = d.choice(w * dep, n_bld)
    wall = d.uniform(0, 1, n_bld) < scene["wall_share"]
    u, v = d.uniform(-0.5, 0.5, n_bld), d.uniform(-0.5, 0.5, n_bld)
    side_pick = d.integers(4, n_bld)
    edge_u = torch.where(side_pick == 0, -0.5, 0.5).to(torch.float64)
    edge_v = torch.where(side_pick == 2, -0.5, 0.5).to(torch.float64)
    u = torch.where(wall & (side_pick < 2), edge_u, u)
    v = torch.where(wall & (side_pick >= 2), edge_v, v)
    x = d.take(cx, which) + u * d.take(w, which)
    y = d.take(cy, which) + v * d.take(dep, which)
    ground = height(x, y)
    roof = d.take(top, which)
    z = torch.where(wall, ground + d.uniform(0, 1, n_bld) * (roof - ground),
                    roof + d.normal(0.03, n_bld))
    xs.append(x), ys.append(y), zs.append(z)
    ret.append(full(0x11, n_bld)), cls.append(full(6, n_bld))
    # vegetation: a first return for each pulse that hits a crown, then the
    # pulses' further returns, half intermediate and half last (ground)
    nt = scene["trees_per_tile"]
    tx, ty = lay.uniform(x0, x0 + side, nt), lay.uniform(y0, y0 + side, nt)
    crown, tall = lay.uniform(2, 6, nt), lay.uniform(5, 25, nt)
    which = d.integers(nt, n_veg)
    r = d.take(crown, which) * d.uniform(0, 1, n_veg).sqrt()
    a = d.uniform(0, 2 * np.pi, n_veg)
    x = (d.take(tx, which) + r * a.cos()).clamp(x0, x0 + side - 0.01)
    y = (d.take(ty, which) + r * a.sin()).clamp(y0, y0 + side - 0.01)
    rank = torch.arange(n_veg, device=device)
    first = rank < n_pulse_veg
    middle = ~first & (rank < n_pulse_veg + (n_veg - n_pulse_veg) // 2)
    frac = torch.where(first, d.uniform(0.5, 1.0, n_veg),
                       torch.where(middle, d.uniform(0.1, 0.5, n_veg),
                                   torch.zeros(n_veg, dtype=torch.float64,
                                               device=device)))
    xs.append(x), ys.append(y)
    zs.append(height(x, y) + frac * d.take(tall, which))
    ret.append(torch.where(first, 0x31, torch.where(middle, 0x32, 0x33))
               .to(torch.uint8))
    cls.append(torch.where(first | middle, 5, 2).to(torch.uint8))

    pos = torch.stack([torch.cat(xs), torch.cat(ys), torch.cat(zs)], dim=1)
    scale = torch.as_tensor(scene["las_scale"], dtype=torch.float64,
                            device=device)
    order = d.permutation(n)  # pulses interleave as the scanner flies
    raw = torch.floor(pos / scale).to(torch.int32)[order]
    rgb = _ortho(raw[:, 0] * scale[0], raw[:, 1] * scale[1],
                 scene["ortho_gsd_m"], seed)
    return (raw.cpu().numpy(), rgb.cpu().numpy(),
            torch.cat(ret)[order].cpu().numpy(),
            torch.cat(cls)[order].cpu().numpy())


def las_positions(raw: np.ndarray, scale) -> np.ndarray:
    """What a LAS reader decodes: raw * scale + offset (0) in f64, as f32."""
    return (raw.astype(np.float64) * np.asarray(scale, np.float64)).astype(
        np.float32)


def las_colors(rgb: np.ndarray) -> np.ndarray:
    """RGBA u8 of u16 channels holding 0-255 values; alpha opaque."""
    out = np.empty((len(rgb), 4), np.uint8)
    out[:, :3] = rgb
    out[:, 3] = 255
    return out



def aerial_counts(scene: dict) -> tuple[int, int, int, int]:
    """Points of a tile: (ground, building, vegetation first returns,
    vegetation returns in all). Every pulse gives one first or single
    return, ``pulses_per_m2`` of them a square metre; a vegetation pulse
    adds ``extra_returns_per_vegetation_pulse`` further returns on
    average, so the points outnumber the pulses."""
    side = float(scene["tile_m"])
    pulses = int(round(scene["pulses_per_m2"] * side * side))
    share = scene["class_share"]
    n_bld = int(pulses * share["building"])
    n_pulse_veg = int(pulses * share["vegetation"])
    n_veg = n_pulse_veg + int(round(
        n_pulse_veg * scene["extra_returns_per_vegetation_pulse"]))
    return pulses - n_bld - n_pulse_veg, n_bld, n_pulse_veg, n_veg
