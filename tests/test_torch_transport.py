"""The port's run_projection on the CPU (plain versions of its kernels)
against the physics checks of tests/test_transport.py, the JAX engine's
golden slab channel sums and, for the dose tally, the JAX engine's
run_projection on the same scene.

History counts are those of tests/test_transport.py except where noted:
the Beer-Lambert runs use 400k histories per image (JAX: 800k), which puts
the primary ratio's Poisson error near 2.6%, so the rel 0.08 bound is about
3 standard errors; the air flat field uses 200k (JAX: 400k)."""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import ct as jct
from cbctmc_tpu.engine import tables as jtables
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import Spectrum as JaxSpectrum
from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
from cbctmc_tpu_torch.engine.rng import make_key
from cbctmc_tpu_torch.engine.tables import build_device_tables, build_woodcock_table
from cbctmc_tpu_torch.engine import transport
from cbctmc_tpu_torch.engine.transport import (
    EngineConfig,
    LaneState,
    make_voxel_volume,
    production_engine_config,
    run_projection,
    run_projection_stepwise,
)
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import Spectrum, default_spectrum

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

    run.scene = (tables, woodcock, volume, src, det)
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


@pytest.mark.parametrize("override", [dict(tau_table=False)])
def test_unported_paths_raise(table_set, tables, override):
    """The one configuration the engine refuses, as the JAX engine does:
    the analytic Compton angle under the v4 body (it runs under v3,
    resolve_inplace=False)."""
    mats, dens = _scene(table_set, False)
    run = _make_run(table_set, tables, mats, dens,
                    config=EngineConfig(n_lanes=256, max_virtual_trips=2, **override))
    with pytest.raises(ValueError, match="resolve_inplace requires tau_table"):
        run(100, 0)


def test_production_config_is_the_sweep_winner():
    cfg = production_engine_config()
    assert (cfg.n_lanes, cfg.max_virtual_trips, cfg.n_resolves) == (65536, 2, 2)
    assert cfg.resolve_inplace and cfg.sigma_mode == "cheb"
    assert cfg.spectrum_mode == "cdf" and cfg.rayleigh_mode == "icdf"
    assert production_engine_config(n_lanes=1024).n_lanes == 1024


# ---------------------------------------------------------------------------
# the engine's v4 options through the plain versions
# ---------------------------------------------------------------------------
OPTIONS = {
    "alias": dict(spectrum_mode="alias"),
    "table": dict(sigma_mode="table"),
    "rita": dict(rayleigh_mode="rita"),
    "all": dict(spectrum_mode="alias", sigma_mode="table", rayleigh_mode="rita",
                tally_dose=True),
}


def _option_config(name):
    return dataclasses.replace(CONFIG, **OPTIONS[name])


@pytest.mark.parametrize("name", list(OPTIONS))
def test_golden_slab_under_each_option(table_set, tables, name):
    """test_golden_slab_channel_sums under each sampling option and all four
    options together: the mean of 4 seeds within 4 combined standard errors
    of the JAX engine's golden channel sums."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens, config=_option_config(name))
    sums = []
    for k in range(4):
        out = run(120_000, 1234 + k)
        image = out[0] if isinstance(out, tuple) else out
        sums.append(image.double().numpy().sum(axis=(1, 2)))
    sums = np.array(sums)
    mean = sums.mean(axis=0)
    s = sums.std(axis=0, ddof=1)
    bound = 4.0 * np.sqrt(s**2 / 4 + s**2)
    golden = np.array(GOLDEN["channel_sums"])
    assert (np.abs(mean - golden) <= bound).all(), (name, mean, golden, bound)
    assert (s > 0).all()


def test_alias_spectrum_agrees_with_the_cdf_on_the_default_spectrum(table_set):
    """On the 120-bin default spectrum (where the alias and inverse-CDF
    samplers map uniforms differently): channel sums of 3 seeds each within
    4 combined standard errors."""
    mats, dens = _scene(table_set, True)
    poly = build_device_tables(table_set, default_spectrum(), device="cpu")
    out = {}
    for mode in ("cdf", "alias"):
        run = _make_run(table_set, poly, mats, dens,
                        config=dataclasses.replace(CONFIG, spectrum_mode=mode))
        out[mode] = np.array([run(60_000, 77 + k).double().numpy().sum(axis=(1, 2))
                              for k in range(3)])
    a, b = out["alias"], out["cdf"]
    limit = 4.0 * np.sqrt(a.var(axis=0, ddof=1) / 3 + b.var(axis=0, ddof=1) / 3)
    assert (np.abs(a.mean(axis=0) - b.mean(axis=0)) <= limit).all(), (a, b)


def test_dose_tally(table_set, tables):
    """tests/test_transport.py:187-210 on the port: the dose lands in the
    water, voxel and material totals agree, and energy accounting closes."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens,
                    config=dataclasses.replace(CONFIG, tally_dose=True))
    n_hist = 100_000
    img, extras = run(n_hist, 11)
    voxel_dose = extras["voxel_dose"].double().numpy()
    material_dose = extras["material_dose"].double().numpy()
    n_voxels = int(np.prod(mats.shape))
    assert voxel_dose.shape == (n_voxels,) and material_dose.shape == (table_set.n_materials, 2)
    assert voxel_dose.sum() > 0
    assert voxel_dose.sum() == pytest.approx(material_dose[:, 0].sum(), rel=1e-3)
    water_idx = table_set.index_of("h2o")
    assert material_dose[water_idx, 0] / material_dose[:, 0].sum() > 0.99
    emitted = n_hist * 60_000.0
    deposited = voxel_dose.sum()
    detected_total = float(img.double().sum())
    assert deposited < emitted
    assert deposited + detected_total < emitted * 1.01
    assert material_dose[:, 1].sum() > 0
    # the dose lies in the slab's voxels (x fastest: flat = x + 40 y + 1600 z)
    y = (np.arange(n_voxels) // 40) % 40
    assert voxel_dose[(y < 15) | (y >= 25)].sum() < 0.01 * deposited


DOSE_KEYS = 6
DOSE_HISTORIES = 60_000


def _dose_summary(extras, water):
    """Water's deposited energy and its sum of squares, the voxel dose of
    each of the slab's 10 y layers and of the air around them."""
    voxel = np.asarray(extras["voxel_dose"], np.float64).reshape(40, 40, 40)  # [z, y, x]
    layers = voxel.sum(axis=(0, 2))
    material = np.asarray(extras["material_dose"], np.float64)
    return np.concatenate([material[water], layers[15:25],
                           [layers[:15].sum() + layers[25:].sum()]])


def _jax_slab_run(mats, dens, config):
    """tests/test_transport.py's run_projection on the same scene."""
    table_set = jax_material_set()
    mono = JaxSpectrum(name="mono60", energies=np.array([59_995.0, 60_005.0], np.float32),
                       probabilities=np.array([1.0], np.float32))
    tables = jtables.build_device_tables(table_set, mono)
    max_density = np.zeros(table_set.n_materials, np.float32)
    np.maximum.at(max_density, mats.astype(int).reshape(-1) - 1, dens.reshape(-1))
    woodcock = jtables.build_woodcock_table(table_set, max_density)
    volume = jtransport.make_voxel_volume(mats.astype(np.int32) - 1, dens, (0.5, 0.5, 0.5))
    geom = jct.ScanGeometry(
        n_pixels_x=N_PIX, n_pixels_z=N_PIX, detector_size_x=20.0, detector_size_z=20.0,
        sdd=60.0, sad=40.0, aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(10.0, 10.0 - 40.0, 10.0),
    )
    source, detector = jct.build_scan(geom, [270.0])
    src = jax.tree.map(lambda x: jnp.asarray(x[0]), source)
    det = jax.tree.map(lambda x: jnp.asarray(x[0]), detector)

    def run(n_histories, seed):
        return jtransport.run_projection(
            tables, woodcock, volume, src, det, jnp.int32(n_histories),
            jax.random.PRNGKey(seed), n_pixels_x=N_PIX, n_pixels_z=N_PIX, config=config)

    return run


def test_dose_tally_agrees_with_the_jax_engine(table_set, tables):
    """The port's dose against the JAX engine's run_projection with
    tally_dose on the same slab scene and configuration, 6 keys of 60,000
    histories each: water's material_dose (deposits and their squares) and
    the voxel dose summed over each y layer of the slab and over the air,
    each mean within 4 combined standard errors of JAX's."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens,
                    config=dataclasses.replace(CONFIG, tally_dose=True))
    jax_run = _jax_slab_run(mats, dens, jtransport.EngineConfig(
        n_lanes=CONFIG.n_lanes, max_virtual_trips=CONFIG.max_virtual_trips, tally_dose=True))
    water = table_set.index_of("h2o")
    a = np.array([_dose_summary({k: v.numpy() for k, v in run(DOSE_HISTORIES, 300 + k)[1].items()},
                                water) for k in range(DOSE_KEYS)])
    b = np.array([_dose_summary(jax_run(DOSE_HISTORIES, 300 + k)[1], water)
                  for k in range(DOSE_KEYS)])
    assert (a > 0).all() and (b > 0).all()
    limit = 4.0 * np.sqrt(a.var(axis=0, ddof=1) / DOSE_KEYS + b.var(axis=0, ddof=1) / DOSE_KEYS)
    assert (np.abs(a.mean(axis=0) - b.mean(axis=0)) <= limit).all(), (a.mean(0), b.mean(0), limit)


def test_dose_tally_equals_float64_deposits(table_set, tables, monkeypatch):
    """The plain version's float32 material dose against a float64 sum of
    the same deposits (the values its scatter-adds receive): apart by no more
    than sequential float32 summation can err, half an ulp of the total per
    deposit."""
    mats, dens = _scene(table_set, True)
    run = _make_run(table_set, tables, mats, dens,
                    config=dataclasses.replace(CONFIG, tally_dose=True))
    deposits = []
    index_add_ = torch.Tensor.index_add_

    def spy(self, dim, index, source, *args, **kwargs):
        if self.ndim == 2 and self.shape[1] == 2:  # the material dose
            deposits.append(source[index < self.shape[0] - 1, 0].double())
        return index_add_(self, dim, index, source, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    _, extras = run(30_000, 12)
    monkeypatch.undo()
    values = torch.cat(deposits)
    exact = float(values.sum())
    got = float(extras["material_dose"][:, 0].double().sum())
    assert exact > 0 and (values > 0).all()
    assert abs(got - exact) <= values.numel() * float(np.spacing(np.float32(exact))) / 2


def test_table_sigma_parts_from_the_resolve_partials(tables):
    """sigma_mode="table" as in the JAX engine: the flight's total comes from
    the pair table while the resolve branches on the Chebyshev partials, so
    photoelectric takes what the fits miss. The two totals part by the fits'
    error (a few 1e-4 of the total), not by nothing."""
    pair = transport._flight_pair_tables(tables)
    n_mats = tables.n_mats
    energy = torch.linspace(6_000.0, 124_000.0, 400)
    mats = torch.arange(n_mats, dtype=torch.int32)
    e = energy.repeat_interleave(n_mats)
    m = mats.repeat(energy.shape[0])
    ebin = torch.clamp(((e - tables.e0) * tables.ide).to(torch.int32), 0,
                       pair.shape[0] // n_mats - 1)
    ab = pair[(ebin * n_mats + m).long()]
    table_total = ab[:, 0] + e * ab[:, 1]
    coeffs = transport.sigma_coeff_table(tables)
    s_c, s_r, s_p = transport.eval_sigma_partials(tables, e, m, coeffs)
    rel = ((s_c + s_r + s_p) - table_total).abs() / table_total
    assert float(rel.max()) < 2e-3
    assert float(rel.max()) > 0


def test_options_refused_where_not_ported(table_set, tables):
    """The stepwise diagnostic path runs the production configuration only,
    MCScanner refuses tally_dose (the JAX scanner fails on it), and an
    unknown mode is an error."""
    mats, dens = _scene(table_set, False)
    for name in OPTIONS:
        cfg = _option_config(name)
        run = _make_run(table_set, tables, mats, dens, config=cfg)
        with pytest.raises(NotImplementedError, match="stepwise"):
            run_projection_stepwise(*run.scene, 100, make_key(0), N_PIX, N_PIX, config=cfg,
                                    device="cpu")
    from cbctmc_tpu_torch.engine.simulate import MCScanner
    with pytest.raises(NotImplementedError, match="tally_dose"):
        MCScanner(mats, dens, (5.0,) * 3, engine_config=dataclasses.replace(
            CONFIG, tally_dose=True), device="cpu")
    run = _make_run(table_set, tables, mats, dens,
                    config=dataclasses.replace(CONFIG, sigma_mode="spline"))
    with pytest.raises(ValueError, match="sigma_mode"):
        run(100, 0)


def test_bits_row_map_of_the_options():
    """The production map keeps its 76 rows; RITA adds 36 rows to each
    resolve, after the azimuth; the other options read no rows of their own."""
    prod = transport.bits_row_map(production_engine_config())
    assert prod.n_rows == 76 and prod.resolve_rows == transport.RESOLVE_ROWS
    for name in ("alias", "table"):
        assert transport.bits_row_map(production_engine_config(**OPTIONS[name])) == prod
    rita = transport.bits_row_map(production_engine_config(rayleigh_mode="rita"))
    assert rita.n_rows == 76 + 2 * 36 and rita.resolve_rows == transport.RESOLVE_ROWS + 36
    assert rita.resolve[0] == prod.resolve[0]
    assert rita.resolve[1] == prod.resolve[0] + transport.RESOLVE_ROWS + 36
    rows = sorted(r for g in rita.groups().values() for r in g)
    assert rows == list(range(rita.n_rows))
