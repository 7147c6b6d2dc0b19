"""Seeded inputs for the port's kernel tests (no JAX: the card-side tests
import this module on a machine without it)."""

import numpy as np
import torch

from cbctmc_tpu_torch.engine import kernels
from cbctmc_tpu_torch.engine.kernels import Candidates, FlightLanes


def prototype_inputs(seed, n=4096, n_flights=4, grid=16, voxel=0.5, n_mats=4, n_bins=8):
    rng = np.random.default_rng(seed)
    size = grid * voxel
    pos = rng.uniform(0.05 * size, 0.95 * size, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    energy = rng.uniform(20_000.0, 100_000.0, n)
    state = np.stack([
        energy,
        rng.uniform(0.2, 2.0, n),  # mfp_wc [cm]
        rng.integers(0, n_bins, n) * n_mats,  # ebin * n_mats
        np.zeros(n),
    ]).astype(np.float32)
    active = (rng.uniform(size=(1, n)) < 0.9).astype(np.float32)
    u = rng.uniform(1e-7, 1.0, (n_flights, 2, n)).astype(np.float32)
    nvox = grid ** 3
    voxmat = rng.integers(0, n_mats, nvox).astype(np.float32)
    voxden = rng.uniform(0.001, 2.0, nvox).astype(np.float32)
    # inv_mfp = a + E*b, positive and below 1/(mfp_wc * den_max) mostly
    mfp_ab = np.stack([
        rng.uniform(0.05, 0.3, n_bins * n_mats),
        rng.uniform(-1e-6, 1e-6, n_bins * n_mats),
    ], axis=1).astype(np.float32)
    geom = np.array([1 / voxel] * 3 + [size] * 3 + [grid, grid * grid], np.float32)
    return dict(
        n_flights=np.array([n_flights], np.int32), pos=pos, dir=d.astype(np.float32),
        state=state, active=active, u=u, voxmat=voxmat, voxden=voxden, mfp_ab=mfp_ab,
        geom=geom,
    )


N_PIX = 8


def step_world(n=512, seed=0, density=1.0, grid=16, voxel=0.5, n_mats=3):
    """A uniform box (material 1 at ``density``) with air-free words, a
    detector along +y, and lanes inside the box flying in random directions."""
    rng = np.random.default_rng(seed)
    nvox = grid ** 3
    q = int(round(density / (2.0 / kernels._DEN_MASK)))
    word = (1 << 27) | q
    packed = torch.full((nvox,), word, dtype=torch.int32)
    d = 24  # Chebyshev coefficients: constant log sigma per channel
    coeffs = torch.zeros((n_mats, 3 * d + 6))
    coeffs[:, 0] = float(np.log(0.1))
    coeffs[:, d] = float(np.log(0.01))
    coeffs[:, 2 * d] = float(np.log(0.05))
    coeffs[:, 3 * d::2] = 2.0  # s_edge never reached
    size = grid * voxel
    consts = kernels.FlightConsts(
        ints=dict(n=n, nx=grid, ny=grid, nz=grid, n_voxels=nvox, npix_x=N_PIX,
                  npix_z=N_PIX, n_mats=n_mats, cheb_d=d, poly_len=1, air_skip=0,
                  soft_skip=0),
        floats=dict(
            wc_poly=[float(np.log(1.0 / (0.16 * 2.0)))], air_poly=[0.0], soft_poly=[0.0],
            log_e_lo=float(np.log(5000.0)), inv_log_range=1.0 / 3.2, inv_air_den=1.0,
            voxmin=voxel, den_scale=float(np.float32(2.0 / kernels._DEN_MASK)),
            nonair_lo=[0.0] * 3, nonair_hi=[size] * 3,
            bbox_hi=[float(np.float32(size) - np.float32(1.5e-5))] * 3,
            voxel_size=[voxel] * 3, sigma_log_lo=float(np.log(5000.0)),
            sigma_range=3.2, sdir=[0.0, 1.0, 0.0], det_center=[size / 2, 40.0, size / 2],
            rot0=[1.0, 0.0, 0.0], rot2=[0.0, 0.0, 1.0], corner_x=size / 2 - 10.0,
            corner_z=size / 2 - 10.0, inv_pix_x=N_PIX / 20.0, inv_pix_z=N_PIX / 20.0,
        ),
        packed=packed, coeffs=coeffs.float(),
    )
    dirs = rng.normal(size=(3, n))
    dirs /= np.linalg.norm(dirs, axis=0, keepdims=True)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    lanes = FlightLanes(
        px=f(rng.uniform(1, size - 1, n)), py=f(rng.uniform(1, size - 1, n)),
        pz=f(rng.uniform(1, size - 1, n)), dx=f(dirs[0]), dy=f(dirs[1]), dz=f(dirs[2]),
        energy=f(np.full(n, 60_000.0)), ebin=torch.full((n,), 11_000, dtype=torch.int32),
        scatter=torch.zeros(n, dtype=torch.int32), alive=torch.ones(n, dtype=torch.bool),
        pending=torch.zeros(n, dtype=torch.bool), escaped=torch.zeros(n, dtype=torch.bool),
        k_air=torch.zeros(n, dtype=torch.int32), k_soft=torch.zeros(n, dtype=torch.int32),
        vox=torch.zeros(n, dtype=torch.int32), mat_evt=torch.zeros(n, dtype=torch.int32),
        xi=torch.zeros(n), stash_idx=torch.full((n,), 4 * N_PIX * N_PIX, dtype=torch.int32),
        stash_energy=torch.zeros(n), stash_valid=torch.zeros(n, dtype=torch.bool),
        cand_free=torch.ones(n, dtype=torch.bool),
    )
    cdirs = rng.normal(size=(3, n))
    cdirs /= np.linalg.norm(cdirs, axis=0, keepdims=True)
    cand = Candidates(
        px=f(np.full(n, size / 2)), py=f(np.full(n, 1e-3 + 1.0)), pz=f(np.full(n, size / 2)),
        dx=f(cdirs[0]), dy=f(cdirs[1]), dz=f(cdirs[2]), energy=f(np.full(n, 40_000.0)),
        ebin=torch.full((n,), 7_000, dtype=torch.int32),
    )
    return lanes, cand, consts, rng


def clone_lanes(lanes):
    return type(lanes)(*(t.clone() for t in lanes))


# ---------------------------------------------------------------------------
# the engine's phases: a small scene, a state in mid-run, and the comparison
# ---------------------------------------------------------------------------
def slab_engine(device, config, n_pix=32, mono=True, grid=40, angle=270.0):
    """``(tables, woodcock, volume, source, detector, n_pix)`` of the 20 cm
    air cube with a 5 cm water slab across the beam (the golden slab's
    scene), or with ``grid=32`` its 32^3 version, under a mono-energetic or
    the default spectrum, seen from ``angle`` degrees."""
    from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
    from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
    from cbctmc_tpu_torch.engine.transport import make_voxel_volume
    from cbctmc_tpu_torch.physics.materials import default_material_set
    from cbctmc_tpu_torch.physics.spectrum import Spectrum, default_spectrum

    ts = default_material_set()
    spectrum = Spectrum("mono60", np.array([59_995.0, 60_005.0], np.float32),
                        np.array([1.0], np.float32)) if mono else default_spectrum()
    air, water = ts.material("air"), ts.material("h2o")
    shape = (grid,) * 3
    mats = np.full(shape, air.number, np.uint8)
    dens = np.full(shape, air.density, np.float32)
    lo, hi = (3 * grid) // 8, (5 * grid) // 8
    mats[:, lo:hi, :] = water.number
    dens[:, lo:hi, :] = water.density
    max_density = np.zeros(ts.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    voxel = 20.0 / grid
    tables = build_device_tables(ts, spectrum, device=device)
    woodcock = build_woodcock_table(ts, max_density, device=device)
    volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (voxel,) * 3, device=device)
    geom = ScanGeometry(
        n_pixels_x=n_pix, n_pixels_z=n_pix, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(10.0, 10.0 - 40.0, 10.0),
    )
    source, detector = build_scan(geom, [angle], device=device)
    return (tables, woodcock, volume, select_projection(source, 0),
            select_projection(detector, 0), n_pix)


def state_in_mid_run(scene, config, n_histories, seed, iterations=4):
    """``(consts, state, bits)``: the engine state after ``iterations`` outer
    iterations through the plain phases, and the random words of the next
    iteration."""
    from cbctmc_tpu_torch.engine import transport as T
    from cbctmc_tpu_torch.engine.rng import make_key

    tables, woodcock, volume, src, det, n_pix = scene
    dev = volume.packed.device
    C = T.engine_consts(tables, woodcock, volume, src, det, n_pix, n_pix, config)
    st = T.EngineState.start(T.LaneState.empty(config.n_lanes, n_pix * n_pix, dev),
                             n_histories, n_pix * n_pix, key=make_key(seed))
    for _ in range(iterations):
        T.outer_iteration(T._plain_phases(), C, st)
    return C, st, T.iteration_bits(C, st).clone()


def state_diff(a, b):
    """How two engine states differ: ``(lanes where an integer or flag field
    of the lanes or candidates differs, the largest |a - b| / (1 + |b|) of a
    float field on the other lanes, whether the control words the host reads
    (budget, live, iteration, run) / block_dead / the integer counters are
    equal, relative difference of the image sums)``."""
    pairs = list(zip(a.lanes._fields, a.lanes, b.lanes)) + [
        (f"cand.{k}", x, y) for k, x, y in zip(a.cand._fields, a.cand, b.cand)]
    bad = torch.zeros_like(a.lanes.alive)
    for _, x, y in pairs:
        if x.dtype != torch.float32:
            bad |= x != y
    rel = 0.0
    for _, x, y in pairs:
        if x.dtype == torch.float32:
            d = (x - y).abs()[~bad] / (1.0 + y.abs()[~bad])
            rel = max(rel, float(d.max()) if d.numel() else 0.0)
    host_words = [0, 1, 5, 6]  # transport.CTRL_REMAINING, _LIVE, _ITERATION, _RUN
    words_equal = (torch.equal(a.ctrl[host_words], b.ctrl[host_words])
                   and torch.equal(a.block_dead, b.block_dead)
                   and torch.equal(a.counters, b.counters))
    sa, sb = float(a.image.double().sum()), float(b.image.double().sum())
    return bad, rel, words_equal, abs(sa - sb) / max(abs(sb), 1e-30)
