"""The port's run_projection on the CPU (plain versions of its kernels)
against the physics checks of tests/test_transport.py and the JAX engine's
golden slab channel sums.

History counts are those of tests/test_transport.py except where noted:
the Beer-Lambert runs use 400k histories per image (JAX: 800k), which puts
the primary ratio's Poisson error near 2.6%, so the rel 0.08 bound is about
3 standard errors; the air flat field uses 200k (JAX: 400k)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
from cbctmc_tpu_torch.engine.transport import (
    EngineConfig,
    LaneState,
    make_voxel_volume,
    production_engine_config,
    run_projection,
)
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum

torch.set_num_threads(2)

N_PIX = 32
CONFIG = EngineConfig(n_lanes=1 << 14, max_virtual_trips=8)
GOLDEN = json.loads((Path(__file__).parent / "golden_slab_values.json").read_text())


@pytest.fixture(scope="module")
def table_set():
    return default_material_set()


@pytest.fixture(scope="module")
def mono60():
    return Spectrum(
        name="mono60",
        energies=np.array([59_995.0, 60_005.0], np.float32),
        probabilities=np.array([1.0], np.float32),
    )


@pytest.fixture(scope="module")
def tables(table_set, mono60):
    return build_device_tables(table_set, mono60, device="cpu")


def _scene(table_set, with_water_slab):
    """20 cm air cube, optionally with a 5 cm water slab across the beam
    (tests/test_transport.py)."""
    shape = (40, 40, 40)
    air = table_set.material("air")
    water = table_set.material("h2o")
    mats = np.full(shape, air.number, np.uint8)
    dens = np.full(shape, air.density, np.float32)
    if with_water_slab:
        mats[:, 15:25, :] = water.number
        dens[:, 15:25, :] = water.density
    return mats, dens


def _make_run(table_set, tables, mats, dens, theta=-1.0, phi=(-1.0, -1.0), config=CONFIG):
    max_density = np.zeros(table_set.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    woodcock = build_woodcock_table(table_set, max_density, device="cpu")
    volume = make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5, 0.5, 0.5),
                               device="cpu")
    geom = ScanGeometry(
        n_pixels_x=N_PIX, n_pixels_z=N_PIX,
        detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0,
        aperture_phi1=phi[0], aperture_phi2=phi[1], aperture_theta=theta,
        source_position_0=(10.0, 10.0 - 40.0, 10.0),
    )
    source, detector = build_scan(geom, [270.0], device="cpu")
    src, det = select_projection(source, 0), select_projection(detector, 0)

    def run(n_histories, seed, **kwargs):
        return run_projection(
            tables, woodcock, volume, src, det, n_histories, make_key(seed),
            N_PIX, N_PIX, config=config, device="cpu", **kwargs,
        )

    return run


def _simulate(table_set, tables, mats, dens, n_histories, seed, **kw):
    run = _make_run(table_set, tables, mats, dens, **kw)
    return run(n_histories, seed).double().numpy()


def test_beer_lambert_slab_transmission(table_set, tables):
    air_mats, air_dens = _scene(table_set, False)
    slab_mats, slab_dens = _scene(table_set, True)
    img_air = _simulate(table_set, tables, air_mats, air_dens, 400_000, seed=1)
    img_slab = _simulate(table_set, tables, slab_mats, slab_dens, 400_000, seed=2)

    c = N_PIX // 2
    sl = slice(c - 2, c + 2)
    primary_air = img_air[0, sl, sl].sum()
    primary_slab = img_slab[0, sl, sl].sum()
    assert primary_air > 0

    water = table_set.materials[table_set.index_of("h2o")]
    air = table_set.materials[table_set.index_of("air")]
    b = int((60_000.0 - table_set.e0) / table_set.de)
    mu_w = 1.0 / water.mfp_total[b]
    mu_air = 1.0 / air.mfp_total[b]
    expected = np.exp(-(mu_w - mu_air) * 5.0)
    assert primary_slab / primary_air == pytest.approx(expected, rel=0.08)

    assert img_slab[1].sum() > 0  # Compton
    assert img_slab[2].sum() > 0  # Rayleigh
    assert img_air[1:].sum() < 0.05 * img_air[0].sum()


def test_air_flat_field(table_set, tables):
    mats, dens = _scene(table_set, False)
    img = _simulate(table_set, tables, mats, dens, 200_000, seed=3)
    assert img.sum() / (200_000 * 60_000.0) > 0.90
    assert (img.sum(axis=0) > 0).all()
    profile = img[0].sum(axis=0)
    asym = abs(profile[: N_PIX // 2].sum() - profile[N_PIX // 2 :].sum()) / profile.sum()
    assert asym < 0.02


def test_pencil_beam_hits_detector_center(table_set, tables):
    mats, dens = _scene(table_set, False)
    img = _simulate(table_set, tables, mats, dens, 20_000, seed=4,
                    theta=0.02, phi=(0.01, 0.01))
    c = N_PIX // 2
    assert img[0, c - 1 : c + 1, c - 1 : c + 1].sum() / img.sum() > 0.98


def test_energy_conservation_bound(table_set, tables):
    mats, dens = _scene(table_set, True)
    img = _simulate(table_set, tables, mats, dens, 100_000, seed=5)
    assert img.sum() <= 100_000 * 60_005.0


def test_cross_chunk_survivor_carry(table_set, tables):
    """Two N/2 chunks linked by return_carry/carry_in tally the same
    expected image as one drained N-history run."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens)
    n = 160_000
    npix = N_PIX * N_PIX
    img_single = run(n, 3, carry_in=LaneState.empty(CONFIG.n_lanes, npix, "cpu"))
    img_single = img_single.double().numpy()

    img1, extras = run(n // 2, 4, carry_in=LaneState.empty(CONFIG.n_lanes, npix, "cpu"),
                       return_carry=True)
    carry = extras["carry"]
    n_in_flight = int(carry.alive.sum() + carry.pending.sum())
    assert n_in_flight > 1000
    img2 = run(n // 2, 5, carry_in=carry)
    img_chunked = img1.double().numpy() + img2.double().numpy()
    assert img_chunked.sum() == pytest.approx(img_single.sum(), rel=0.02)
    assert img_chunked[0].sum() == pytest.approx(img_single[0].sum(), rel=0.02)


def test_budget_exact_and_stats(table_set, tables):
    """Every history is started exactly once (the exclusive-cumsum budget
    ordering never overdraws), and the counters are consistent."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens)
    n = 50_000 + 123
    _, extras = run(n, 6, return_stats=True)
    counts = extras["counts"].numpy()
    assert int(extras["remaining"]) == 0
    assert counts[5] + counts[6] == n  # refills + adoptions/mid-refills
    assert counts[0] <= n  # at most one record per history
    assert counts[7] > 0 and counts[2] > counts[3] > 0


def test_golden_slab_channel_sums(table_set, tables):
    """The JAX golden file holds one threefry-seeded 120k-history run. The
    port's RNG differs, so the check is statistical: the mean of 4 port
    seeds lies within 4 combined standard errors of the golden value,
    4*sqrt(s^2/4 + s^2), with s the port's per-run spread."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens)
    sums = np.array([
        run(120_000, 1234 + k).double().numpy().sum(axis=(1, 2)) for k in range(4)
    ])
    mean = sums.mean(axis=0)
    s = sums.std(axis=0, ddof=1)
    bound = 4.0 * np.sqrt(s**2 / 4 + s**2)
    golden = np.array(GOLDEN["channel_sums"])
    assert (np.abs(mean - golden) <= bound).all(), (mean, golden, bound)
    assert (s > 0).all()


@pytest.mark.parametrize("override", [
    dict(resolve_inplace=False), dict(sigma_mode="table"), dict(spectrum_mode="alias"),
    dict(rayleigh_mode="rita"), dict(tally_dose=True),
])
def test_unported_paths_raise(table_set, tables, override):
    mats, dens = _scene(table_set, False)
    run = _make_run(table_set, tables, mats, dens,
                    config=EngineConfig(n_lanes=256, max_virtual_trips=2, **override))
    with pytest.raises(NotImplementedError):
        run(100, 0)


def test_production_config_is_the_sweep_winner():
    cfg = production_engine_config()
    assert (cfg.n_lanes, cfg.max_virtual_trips, cfg.n_resolves) == (65536, 2, 2)
    assert cfg.resolve_inplace and cfg.sigma_mode == "cheb"
    assert cfg.spectrum_mode == "cdf" and cfg.rayleigh_mode == "icdf"
    assert production_engine_config(n_lanes=1024).n_lanes == 1024
