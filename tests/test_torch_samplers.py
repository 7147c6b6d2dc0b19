"""The port's engine-v4 samplers against the JAX package's: functions that
take uniforms are fed the same numpy uniforms and must agree exactly (or to
the float32 ulp of a library transcendental, as stated); functions that draw
their own numbers are compared by two-sample Kolmogorov-Smirnov distance
with the bound of tests/test_samplers.py (0.02)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbctmc_tpu.engine import samplers as jsamplers
from cbctmc_tpu.engine import transport as jtransport
from cbctmc_tpu.engine.ct import ScanGeometry as JScanGeometry, build_scan as jbuild_scan
from cbctmc_tpu.engine.rng import uniform_open as juniform_open, uniforms_open as juniforms_open
from cbctmc_tpu.engine.tables import build_device_tables as jax_build_tables
from cbctmc_tpu.physics.materials import default_material_set as jax_material_set
from cbctmc_tpu.physics.spectrum import default_spectrum as jax_spectrum
from cbctmc_tpu_torch.engine import samplers, transport
from cbctmc_tpu_torch.engine.ct import ScanGeometry, build_scan, select_projection
from cbctmc_tpu_torch.engine.rng import make_generator, uniform_open
from cbctmc_tpu_torch.engine.tables import build_device_tables
from cbctmc_tpu_torch.physics.materials import default_material_set
from cbctmc_tpu_torch.physics.spectrum import default_spectrum
from scalar_reference import rayleigh_scalar
from test_sampler_statistics import _chi2_two_sample

torch.set_num_threads(2)

KS_BOUND = 0.02  # tests/test_samplers.py


def max_cdf_distance(a, b):
    """Two-sample Kolmogorov-Smirnov statistic."""
    grid = np.sort(np.concatenate([a, b]))
    ca = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cb = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return np.abs(ca - cb).max()


@pytest.fixture(scope="module")
def jax_tables():
    return jax_build_tables(jax_material_set(), jax_spectrum())


@pytest.fixture(scope="module")
def port_tables():
    return build_device_tables(default_material_set(), default_spectrum(), device="cpu")


@pytest.mark.parametrize("which", ["compton", "rayleigh", "fused"])
def test_icdf_rows_cdt1_matches_jax(jax_tables, port_tables, which):
    """Same uniforms, energies and materials -> the same 1-cos(theta). The
    row index depends on floor(log E) on the coarse log grid; the one-ulp
    freedom of float32 log may move a lane whose position lies within an
    ulp of a knot, so at most 1 lane in 20,000 may differ and all others
    agree to 1e-6 relative."""
    rng = np.random.default_rng(7)
    n = 20_000
    n_mats = port_tables.n_mats
    energy = rng.uniform(5_000.0, 125_000.0, n).astype(np.float32)
    mat = rng.integers(0, n_mats, n).astype(np.int32)
    ray = rng.uniform(size=n) < 0.5
    u2 = rng.uniform(2 ** -25, 1.0, (2, n)).astype(np.float32)
    n_rows = int(port_tables.compton_icdf.shape[0])

    if which == "compton":
        jt, tt = jax_tables.compton_icdf, port_tables.compton_icdf
        jrow = lambda j: j * n_mats + jnp.asarray(mat)
        trow = lambda j: j * n_mats + torch.from_numpy(mat)
    elif which == "rayleigh":
        jt, tt = jax_tables.rayleigh_icdf, port_tables.rayleigh_icdf
        jrow = lambda j: j * n_mats + jnp.asarray(mat)
        trow = lambda j: j * n_mats + torch.from_numpy(mat)
    else:
        jt = jnp.concatenate([jax_tables.compton_icdf, jax_tables.rayleigh_icdf])
        tt = torch.cat([port_tables.compton_icdf, port_tables.rayleigh_icdf])
        jrow = lambda j: jnp.where(jnp.asarray(ray), n_rows, 0) + j * n_mats + jnp.asarray(mat)
        trow = lambda j: (torch.where(torch.from_numpy(ray), n_rows, 0) + j * n_mats
                          + torch.from_numpy(mat))

    ref = np.asarray(jsamplers.sample_icdf_rows_cdt1(
        jnp.asarray(u2), jnp.asarray(energy), jrow, jt, jax_tables))
    got = samplers.sample_icdf_rows_cdt1(
        torch.from_numpy(u2), torch.from_numpy(energy), trow, tt, port_tables).numpy()
    close = np.isclose(got, ref, rtol=1e-6, atol=0)
    assert (~close).sum() <= 1
    assert (got == ref).mean() > 0.999


def test_rotate_direction_matches_jax():
    """Same directions, cosines and azimuths -> the same rotated vectors, to
    2 float32 ulp of 1 (the libraries' sin/cos/sqrt may round apart)."""
    rng = np.random.default_rng(4)
    n = 10_000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:10] = [0.0, 0.0, 1.0]  # the degenerate pole branch
    d[10:20] = [0.0, 0.0, -1.0]
    d = d.astype(np.float32)
    costh = rng.uniform(-1, 1, n).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    ref = jsamplers.rotate_direction(*(jnp.asarray(d[:, k]) for k in range(3)),
                                     jnp.asarray(costh), jnp.asarray(phi))
    got = samplers.rotate_direction(*(torch.from_numpy(d[:, k].copy()) for k in range(3)),
                                    torch.from_numpy(costh), torch.from_numpy(phi))
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=2.4e-7)


def test_uniform_open_lattice():
    u = uniform_open(make_generator("cpu", 3, 1, 2), (4, 50_000), "cpu").numpy()
    assert u.dtype == np.float32
    assert (u > 0).all() and (u < 1).all()
    k = (u - 2.0 ** -25) * 2.0 ** 24
    np.testing.assert_array_equal(k, np.round(k))  # the (bits >> 8) lattice
    assert abs(u.mean() - 0.5) < 0.005
    # (seed, projection, chunk) give distinct streams
    v = uniform_open(make_generator("cpu", 3, 1, 3), (4, 50_000), "cpu").numpy()
    assert not np.array_equal(u, v)


def test_spectrum_energy_cdf_ks(jax_tables, port_tables):
    n = 200_000
    ref = np.asarray(jsamplers.sample_spectrum_energy_cdf(
        jax.random.PRNGKey(6), jax_tables, n))
    got = samplers.sample_spectrum_energy_cdf(
        make_generator("cpu", 6), port_tables, n).numpy()
    spectrum = default_spectrum()
    assert max_cdf_distance(got, ref) < KS_BOUND
    assert got.mean() == pytest.approx(spectrum.mean_energy, rel=3e-3)
    assert got.min() >= spectrum.min_energy and got.max() <= spectrum.max_energy


def _source_geometry(cls):
    return cls(
        n_pixels_x=64, n_pixels_z=64,
        detector_size_x=40.0, detector_size_z=30.0,
        sdd=150.0, sad=100.0,
        aperture_phi1=-1.0, aperture_phi2=-1.0, aperture_theta=-1.0,
        source_position_0=(0.0, -100.0, 0.0),
    )


@pytest.mark.parametrize("angle", [270.0, 33.0])
def test_source_direction_ks(angle):
    n = 50_000
    jsrc, _ = jbuild_scan(_source_geometry(JScanGeometry), [angle])
    jsrc0 = jax.tree.map(lambda x: jnp.asarray(x[0]), jsrc)
    ref = [np.asarray(a) for a in jsamplers.sample_source_direction(
        jax.random.PRNGKey(5), jsrc0, n)]
    src, _ = build_scan(_source_geometry(ScanGeometry), [angle], device="cpu")
    got = [a.numpy() for a in samplers.sample_source_direction(
        make_generator("cpu", 5), select_projection(src, 0), n)]
    ok_r, ok_g = ref[3], got[3]
    assert ok_g.mean() == pytest.approx(ok_r.mean(), abs=0.005)
    for k in range(3):
        assert max_cdf_distance(got[k][ok_g], ref[k][ok_r]) < KS_BOUND
    np.testing.assert_allclose(got[0] ** 2 + got[1] ** 2 + got[2] ** 2, 1.0, atol=1e-5)


def test_compton_rows_tab_ks(jax_tables, port_tables):
    """The Compton shell + Doppler stage at a fixed angle distribution, water
    at 60 keV: scattered energies agree in distribution."""
    n = 40_000
    table_set = default_material_set()
    w = table_set.index_of("h2o")
    rng = np.random.default_rng(9)
    cdt1 = rng.uniform(0.0, 2.0, n).astype(np.float32)
    energy = np.full(n, 60_000.0, np.float32)
    mask = np.ones(n, bool)

    ui_j = jnp.where(jnp.isinf(jax_tables.shell_ui), 1e30, jax_tables.shell_ui)
    rows = lambda t: jnp.repeat(t[w][:, None], n, axis=1)
    ref_e, ref_c = jsamplers.compton_scatter_rows_tab(
        jax.random.PRNGKey(1), jnp.asarray(energy), jnp.asarray(cdt1),
        rows(jax_tables.shell_f), rows(ui_j), rows(jax_tables.shell_j0),
        jnp.asarray(mask))
    ui_t = torch.where(torch.isinf(port_tables.shell_ui), 1e30, port_tables.shell_ui)
    trows = lambda t: t[w][None, :].expand(n, -1).contiguous()
    got_e, got_c = samplers.compton_scatter_rows_tab(
        make_generator("cpu", 1), torch.from_numpy(energy), torch.from_numpy(cdt1),
        trows(port_tables.shell_f), trows(ui_t), trows(port_tables.shell_j0),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(ref_c), rtol=0, atol=1e-6)
    assert max_cdf_distance(got_e.numpy(), np.asarray(ref_e)) < KS_BOUND
    assert (got_e.numpy() <= 60_000.0 + 1e-3).all()


# ---------------------------------------------------------------------------
# the samplers of the engine's v4 options, on JAX's own uniforms
# ---------------------------------------------------------------------------
def test_spectrum_energy_alias_bit_equal(jax_tables, port_tables):
    """Walker alias on the uniforms JAX draws from the key (two split keys):
    every energy equal."""
    n = 200_000
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jsamplers.sample_spectrum_energy(key, jax_tables, n))
    u = np.stack([np.asarray(a) for a in juniforms_open(key, 2, (n,))])
    got = samplers.sample_spectrum_energy_u(torch.from_numpy(u),
                                            samplers.spectrum_alias_table(port_tables))
    np.testing.assert_array_equal(got.numpy(), ref)
    spectrum = default_spectrum()
    assert got.numpy().mean() == pytest.approx(spectrum.mean_energy, rel=3e-3)


def _rita_lanes(port_tables, n, seed, low=5_000.0):
    rng = np.random.default_rng(seed)
    energy = rng.uniform(low, 125_000.0, n).astype(np.float32)
    mat = rng.integers(0, port_tables.n_mats, n).astype(np.int32)
    e0, ide = float(port_tables.e0), float(port_tables.ide)
    ebin = np.clip(((energy - np.float32(e0)) * np.float32(ide)).astype(np.int32), -1, None)
    mask = rng.uniform(size=n) < 0.9
    return energy, mat, ebin, mask


@pytest.mark.parametrize("low", [5_000.0, 60_000.0])
def test_rayleigh_scatter_rows_bit_equal(jax_tables, port_tables, low):
    """RITA + Thomson rejection on the uniforms JAX draws for its 12 trips:
    cos(theta) and the acceptance mask equal lane for lane, over every
    material and the energy grid (the transport's pmax of the next bin)."""
    n = 40_000
    energy, mat, ebin, mask = _rita_lanes(port_tables, n, 5 if low < 10_000 else 6, low)
    n_bins = port_tables.rayleigh_pmax.shape[0] // port_tables.n_mats
    pmax = np.asarray(jax_tables.rayleigh_pmax)[
        np.clip(ebin + 1, 0, n_bins - 1) * port_tables.n_mats + mat]
    key = jax.random.PRNGKey(int(low))
    ref_c, ref_a = jsamplers.rayleigh_scatter_rows(
        key, jnp.asarray(energy), jnp.asarray(mat), jnp.asarray(pmax), jax_tables,
        jnp.asarray(mask), return_accepted=True)
    u = np.array(juniform_open(key, (3 * jsamplers.RAYLEIGH_TRIPS, n)))
    got_c, got_a = samplers.rayleigh_scatter_rows_u(
        torch.from_numpy(u), torch.from_numpy(energy), torch.from_numpy(mat),
        torch.from_numpy(pmax.copy()), port_tables, torch.from_numpy(mask),
        return_accepted=True)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(ref_c))
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(ref_a))
    assert got_a.numpy()[mask].mean() > 0.999


def test_rayleigh_pmax_clamps_as_xla(jax_tables, port_tables):
    """``rayleigh_scatter`` reads pmax at (ebin + 1) * n_mats + mat
    unclipped; XLA clamps the index into the table, and the port clamps it
    the same way (the last bin and the -1 of a below-grid energy)."""
    n_mats = port_tables.n_mats
    n_bins = port_tables.rayleigh_pmax.shape[0] // n_mats
    ebin = np.array([-1, 0, 7, n_bins - 2, n_bins - 1, n_bins - 1], np.int32)
    mat = np.array([0, 3, n_mats - 1, 5, 0, n_mats - 1], np.int32)
    ref = np.asarray(jax_tables.rayleigh_pmax[(jnp.asarray(ebin) + 1) * n_mats
                                              + jnp.asarray(mat)])
    got = samplers.rayleigh_pmax(port_tables, torch.from_numpy(ebin), torch.from_numpy(mat))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_rita_rows_non_decreasing(port_tables):
    """The kernel's bisection over a RITA p row finds the JAX compare-count's
    interval only where the row is non-decreasing: every material's is."""
    p = port_tables.rita_p.reshape(-1, 128)
    assert bool((p[:, 1:] >= p[:, :-1]).all())


@pytest.mark.parametrize("which", ["compton", "rayleigh"])
def test_cdt1_tab_matches_jax(jax_tables, port_tables, which):
    """``sample_compton_cdt1_tab`` / ``sample_rayleigh_cdt1_tab`` on JAX's
    uniforms, with test_icdf_rows_cdt1_matches_jax's tolerance."""
    rng = np.random.default_rng(13)
    n = 20_000
    energy = rng.uniform(5_000.0, 125_000.0, n).astype(np.float32)
    mat = rng.integers(0, port_tables.n_mats, n).astype(np.int32)
    u2 = np.array(jax.random.uniform(jax.random.PRNGKey(2), (2, n)), np.float32)
    jfn = getattr(jsamplers, f"sample_{which}_cdt1_tab")
    fn = getattr(samplers, f"sample_{which}_cdt1_tab")
    ref = np.asarray(jfn(jnp.asarray(u2), jnp.asarray(energy), jnp.asarray(mat), jax_tables))
    got = fn(torch.from_numpy(u2), torch.from_numpy(energy), torch.from_numpy(mat),
             port_tables).numpy()
    assert (~np.isclose(got, ref, rtol=1e-6, atol=0)).sum() <= 1
    assert (got == ref).mean() > 0.999


def test_flight_pair_tables_bit_equal(jax_tables, port_tables):
    ref = np.asarray(jtransport._flight_pair_tables(jax_tables))
    got = transport._flight_pair_tables(port_tables).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_rayleigh_rita_chi2_vs_scalar_reference(port_tables):
    """tests/test_sampler_statistics.py's Rayleigh chi-square on the port's
    RITA sampler (water, 60 keV): 200,000 port samples against 50,000 of
    the scalar reference, chi2 / dof below 1.6 on 50 quantile bins."""
    table_set = default_material_set()
    energy = 60_000.0
    mat_idx = table_set.index_of("h2o")
    ebin = int((energy - table_set.e0) / table_set.de)
    gen = make_generator("cpu", 3)
    n, chunk = 200_000, 50_000
    got = np.concatenate([samplers.rayleigh_scatter(
        gen, torch.full((chunk,), energy), torch.full((chunk,), mat_idx, dtype=torch.int32),
        torch.full((chunk,), ebin, dtype=torch.int32), port_tables,
        torch.ones((chunk,), dtype=torch.bool)).numpy() for _ in range(n // chunk)])
    m_tab = table_set.materials[mat_idx]
    rita = {"x": m_tab.rita_x, "p": m_tab.rita_p, "a": m_tab.rita_a, "b": m_tab.rita_b,
            "itl": m_tab.rita_itl, "itu": m_tab.rita_itu}
    pmax = float(m_tab.rayleigh_pmax[ebin + 1])
    rng = np.random.default_rng(8)
    ref = np.array([rayleigh_scalar(rng, energy, rita, pmax) for _ in range(50_000)])
    assert _chi2_two_sample(got, ref) < 1.6
