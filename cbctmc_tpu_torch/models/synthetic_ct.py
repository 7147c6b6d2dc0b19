"""Synthetic labelled thorax CTs for segmenter training.

The port's copy of the JAX package's generator
(``scripts/generate_synthetic_ct.py``, numpy only; its functions below are
that file's, character for character, so one seed makes the same case).
The reference trained its 9-label FlexUNet segmenter on TotalSegmentator-
derived patient labels; no patient data ships with either repo, so the
weights are trained on procedurally generated anatomies: elliptical bodies
with fat/muscle shells, spine + rib bones, two lungs with random vessel
trees, liver and stomach blobs, CT-realistic HU values, bias fields and
noise. Labels follow cbctmc/segmentation/labels.py ordering: [background,
upper_body_bones, upper_body_muscles, upper_body_fat, liver, stomach, lung,
other, lung_vessels] (:data:`cbctmc_tpu_torch.models.segmentation.LABELS`).
"""

from pathlib import Path

import numpy as np

N_LABELS = 9
(BG, BONES, MUSCLES, FAT, LIVER, STOMACH, LUNG, OTHER, VESSELS) = range(9)

HU = {
    "air": -1000.0, "lung": -760.0, "fat": -90.0, "muscle": 45.0,
    "other": 25.0, "liver": 60.0, "stomach": -30.0, "bone": 450.0,
    "vessel": 30.0,
}


def _ellipsoid(shape, center, radii, rng=None, wobble=0.0):
    grids = [
        (np.arange(s, dtype=np.float32) - c) / r
        for s, c, r in zip(shape, center, radii)
    ]
    d2 = (
        grids[0][:, None, None] ** 2
        + grids[1][None, :, None] ** 2
        + grids[2][None, None, :] ** 2
    )
    if wobble and rng is not None:
        d2 = d2 * (1.0 + wobble * rng.standard_normal())
    return d2 <= 1.0


def _tube(shape, p0, direction, radius, length):
    """A straight cylinder segment (vessel branch)."""
    t = np.linspace(0, length, int(length) + 1)
    pts = np.asarray(p0)[None] + t[:, None] * np.asarray(direction)[None]
    mask = np.zeros(shape, bool)
    for p in pts:
        lo = np.maximum(np.floor(p - radius).astype(int), 0)
        hi = np.minimum(np.ceil(p + radius).astype(int) + 1, shape)
        if (hi <= lo).any():
            continue
        xs = np.arange(lo[0], hi[0])[:, None, None]
        ys = np.arange(lo[1], hi[1])[None, :, None]
        zs = np.arange(lo[2], hi[2])[None, None, :]
        d2 = (xs - p[0]) ** 2 + (ys - p[1]) ** 2 + (zs - p[2]) ** 2
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] |= d2 <= radius**2
    return mask


def generate_case(seed: int, shape=(144, 112, 96)):
    """Returns (image_hu f32 [x,y,z], labels f32 [9,x,y,z])."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    labels = np.zeros((N_LABELS, *shape), np.float32)

    cx, cy = nx / 2 + rng.uniform(-6, 6), ny / 2 + rng.uniform(-4, 4)
    body_rx = nx * rng.uniform(0.38, 0.45)
    body_ry = ny * rng.uniform(0.36, 0.44)

    body = _ellipsoid(shape, (cx, cy, nz / 2), (body_rx, body_ry, nz), rng)
    fat = body & ~_ellipsoid(
        shape, (cx, cy, nz / 2),
        (body_rx * rng.uniform(0.86, 0.93), body_ry * rng.uniform(0.84, 0.92), nz),
    )
    muscle = (
        body & ~fat
        & ~_ellipsoid(
            shape, (cx, cy, nz / 2),
            (body_rx * rng.uniform(0.72, 0.8), body_ry * rng.uniform(0.7, 0.8), nz),
        )
    )
    interior = body & ~fat & ~muscle

    # lungs
    lungs = np.zeros(shape, bool)
    lung_centers = []
    for side in (-1, 1):
        c = (
            cx + side * body_rx * rng.uniform(0.38, 0.48),
            cy - body_ry * rng.uniform(0.0, 0.12),
            nz / 2 + rng.uniform(-4, 4),
        )
        r = (
            body_rx * rng.uniform(0.26, 0.33),
            body_ry * rng.uniform(0.42, 0.52),
            nz * rng.uniform(0.38, 0.48),
        )
        lungs |= _ellipsoid(shape, c, r, rng) & interior
        lung_centers.append((c, r))

    # vessel trees inside the lungs
    vessels = np.zeros(shape, bool)
    for c, r in lung_centers:
        for _ in range(rng.integers(6, 12)):
            d = rng.standard_normal(3)
            d /= np.linalg.norm(d)
            vessels |= _tube(
                shape, c, d, rng.uniform(0.8, 2.0), rng.uniform(8, r[0] * 1.5)
            )
    vessels &= lungs

    # spine + ribs
    bones = np.zeros(shape, bool)
    bones |= _ellipsoid(
        shape, (cx, cy + body_ry * 0.78, nz / 2), (7.5, 8.5, nz), rng
    ) & body
    for k in range(int(nz // 14)):
        z = 7 + 14 * k + rng.uniform(-2, 2)
        ring = _ellipsoid(
            shape, (cx, cy, z), (body_rx * 0.92, body_ry * 0.92, 2.2)
        ) & ~_ellipsoid(
            shape, (cx, cy, z), (body_rx * 0.83, body_ry * 0.83, 2.4)
        )
        bones |= ring & body & ~lungs

    # liver (lower-left lung side): a multi-lobe union with varied size,
    # position and orientation — the single fixed ellipsoid of rounds 1-4
    # let the net memorise position instead of appearance (eval Dice
    # 0.40-0.51; VERDICT round-4 weak item 4 / next-step 9)
    lc = (
        cx - body_rx * rng.uniform(0.2, 0.4),
        cy + body_ry * rng.uniform(-0.05, 0.18),
        nz * rng.uniform(0.12, 0.3),
    )
    liver = _ellipsoid(
        shape, lc,
        (body_rx * rng.uniform(0.28, 0.42), body_ry * rng.uniform(0.32, 0.48),
         nz * rng.uniform(0.16, 0.28)),
        rng, wobble=0.08,
    )
    for _ in range(rng.integers(1, 3)):  # extra lobes
        off = rng.uniform(-1, 1, 3) * (body_rx * 0.18, body_ry * 0.18, nz * 0.1)
        liver |= _ellipsoid(
            shape, (lc[0] + off[0], lc[1] + off[1], lc[2] + off[2]),
            (body_rx * rng.uniform(0.14, 0.26), body_ry * rng.uniform(0.16, 0.3),
             nz * rng.uniform(0.1, 0.2)),
            rng, wobble=0.1,
        )
    liver = liver & interior & ~lungs

    # stomach: a curved, partly gas-filled pouch (crescent = ellipsoid
    # minus an offset core), with free size/position/rotation
    sc = (
        cx + body_rx * rng.uniform(0.15, 0.4),
        cy + body_ry * rng.uniform(0.0, 0.22),
        nz * rng.uniform(0.1, 0.28),
    )
    srx = body_rx * rng.uniform(0.16, 0.28)
    sry = body_ry * rng.uniform(0.18, 0.3)
    srz = nz * rng.uniform(0.1, 0.2)
    stomach_outer = _ellipsoid(shape, sc, (srx, sry, srz), rng, wobble=0.08)
    bite = _ellipsoid(
        shape,
        (sc[0] + srx * rng.uniform(0.4, 0.9) * rng.choice([-1, 1]),
         sc[1] + sry * rng.uniform(0.2, 0.7),
         sc[2]),
        (srx * rng.uniform(0.5, 0.9), sry * rng.uniform(0.5, 0.9),
         srz * rng.uniform(0.8, 1.3)),
        rng,
    )
    stomach = stomach_outer & (~bite if rng.random() < 0.7 else True)
    stomach = stomach & interior & ~lungs & ~liver

    other = interior & ~lungs & ~liver & ~stomach & ~bones

    labels[BONES][bones] = 1
    labels[LUNG][lungs & ~bones] = 1
    labels[VESSELS][vessels & ~bones] = 1
    labels[LIVER][liver & ~bones] = 1
    labels[STOMACH][stomach & ~bones] = 1
    labels[MUSCLES][muscle & ~bones] = 1
    labels[FAT][fat & ~bones] = 1
    labels[OTHER][other & ~lungs & ~liver & ~stomach] = 1
    assigned = labels[1:].sum(axis=0) > 0
    labels[BG][~assigned] = 1

    image = np.full(shape, HU["air"], np.float32)
    image[other] = HU["other"] + rng.uniform(-10, 10)
    image[muscle] = HU["muscle"] + rng.uniform(-8, 8)
    image[fat] = HU["fat"] + rng.uniform(-15, 15)
    # organ contrast varies per scan (perfusion/contrast agent): draw the
    # liver and stomach HU from their clinical ranges so the net must use
    # appearance AND shape, not a memorised grey value
    image[liver] = rng.uniform(40.0, 75.0)
    image[stomach] = rng.uniform(-60.0, 45.0)
    if rng.random() < 0.5:  # gas bubble in the stomach lumen
        gas = _ellipsoid(
            shape,
            (sc[0], sc[1] - sry * 0.3, sc[2] + srz * rng.uniform(0.1, 0.4)),
            (srx * 0.45, sry * 0.35, srz * 0.4), rng,
        ) & stomach
        image[gas] = rng.uniform(-850.0, -600.0)
    image[lungs] = HU["lung"] + rng.uniform(-60, 60)
    image[vessels] = HU["vessel"] + rng.uniform(-10, 10)
    image[bones] = HU["bone"] * rng.uniform(0.8, 1.3)

    # smooth bias field + noise
    f = rng.standard_normal((5, 5, 4)).astype(np.float32) * 18.0
    bias = np.kron(f, np.ones((nx // 5 + 1, ny // 5 + 1, nz // 4 + 1), np.float32))
    image += bias[:nx, :ny, :nz]
    image += rng.standard_normal(shape).astype(np.float32) * 18.0
    return image, labels


def write_cases(output_folder, n_cases: int = 10, first_seed: int = 1000,
                shape=(144, 112, 96)) -> list:
    """``image_{i:03d}.npy`` / ``labels_{i:03d}.npy`` for seeds
    ``first_seed + i`` (the JAX script's layout); returns the stems."""
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    for i in range(n_cases):
        image, labels = generate_case(seed=first_seed + i, shape=shape)
        np.save(output_folder / f"image_{i:03d}.npy", image)
        np.save(output_folder / f"labels_{i:03d}.npy", labels)
    return [f"{i:03d}" for i in range(n_cases)]
