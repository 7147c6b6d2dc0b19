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
