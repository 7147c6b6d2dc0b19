"""The port's interchange path against the JAX package's, on the CPU: the
``.mcgpu`` material files parsed and packed (``MaterialTableSet.
from_mcgpu_files`` / ``from_directory`` / ``save_npz``), the spectra read,
filtered, written and derived, the penEasy ``.vox`` geometry and the MC-GPU
input exported, the native C++ codecs (built here by ``g++``) and the
``utils/common`` helpers.

Everything here is host numpy (and C++) in both packages, so the port is
held bit-equal: arrays with ``np.array_equal``, files byte for byte (a
gzipped file by its decompressed payload), and each package's reader reads
the other's file to the same tables."""

import dataclasses
import gzip

import numpy as np
import pytest

from cbctmc_tpu import native as jnative
from cbctmc_tpu.physics import material_generator as jgen
from cbctmc_tpu.physics import materials as jmaterials
from cbctmc_tpu.physics import spectrum as jspectrum
from cbctmc_tpu.utils import common as jcommon
from cbctmc_tpu.utils import interchange as jinterchange
from cbctmc_tpu_torch import interop, native
from cbctmc_tpu_torch.physics import materials as tmaterials
from cbctmc_tpu_torch.physics import spectrum as tspectrum
from cbctmc_tpu_torch.utils import common as tcommon
from cbctmc_tpu_torch.utils import interchange as tinterchange
from test_torch_material_generator import _equal, _tables_equal, fake_mu

# (identifier, formula, density): listed out of density order on purpose
COMPOUNDS = [("acrylic", "C5H8O2", 1.19), ("air_like", "N", 0.0012), ("h2o", "H2O", 1.0)]


@pytest.fixture(scope="module")
def mcgpu_dir(tmp_path_factory):
    """Three generated materials (5-30 keV) written as ``.mcgpu`` files, one
    of them gzipped."""
    folder = tmp_path_factory.mktemp("materials")
    for i, (identifier, formula, density) in enumerate(COMPOUNDS):
        m = jgen.generate_material(identifier, formula, density, e_max=30_000.0,
                                   mu_rho_fn=fake_mu)
        path = jgen.write_mcgpu_file(m, folder / f"{identifier}__5_30kev.mcgpu")
        if i == 0:
            with gzip.open(folder / f"{path.name}.gz", "wb") as f:
                f.write(path.read_bytes())
    return folder


def _sets_equal(ours, theirs):
    assert ours.identifiers == theirs.identifiers
    for a, b in zip(ours.materials, theirs.materials):
        _tables_equal(a, b)


@pytest.mark.parametrize("suffix", [".mcgpu", ".mcgpu.gz"])
def test_parse_mcgpu_material_file_matches_jax(mcgpu_dir, suffix):
    path = mcgpu_dir / f"acrylic__5_30kev{suffix}"
    ours = tmaterials.parse_mcgpu_material_file(path)
    _tables_equal(ours, jmaterials.parse_mcgpu_material_file(path))
    assert ours.identifier == "acrylic" and ours.n_shells == 7


def test_from_mcgpu_files_sorts_by_density_as_jax(mcgpu_dir):
    paths = [mcgpu_dir / f"{c[0]}__5_30kev.mcgpu" for c in COMPOUNDS]
    ours = tmaterials.MaterialTableSet.from_mcgpu_files(paths)
    assert ours.identifiers == ["air_like", "h2o", "acrylic"]
    assert ours.material("acrylic").number == 3
    _sets_equal(ours, jmaterials.MaterialTableSet.from_mcgpu_files(paths))


def test_from_directory_matches_jax(mcgpu_dir, tmp_path):
    ours = tmaterials.MaterialTableSet.from_directory(mcgpu_dir)
    _sets_equal(ours, jmaterials.MaterialTableSet.from_directory(mcgpu_dir))
    gz = tmaterials.MaterialTableSet.from_directory(mcgpu_dir, "*.mcgpu.gz")
    assert gz.identifiers == ["acrylic"]
    with pytest.raises(FileNotFoundError):
        tmaterials.MaterialTableSet.from_directory(tmp_path)


def test_from_mcgpu_files_refuses_mixed_grids(mcgpu_dir, tmp_path):
    m = jgen.generate_material("w", "H2O", 1.0, e_min=6000.0, e_max=30_000.0, mu_rho_fn=fake_mu)
    other = jgen.write_mcgpu_file(m, tmp_path / "w__6_30kev.mcgpu")
    with pytest.raises(ValueError, match="one energy grid"):
        tmaterials.MaterialTableSet.from_mcgpu_files([mcgpu_dir / "h2o__5_30kev.mcgpu", other])


@pytest.mark.parametrize("source", ["generated", "shipped"])
def test_save_npz_cross_reads(mcgpu_dir, tmp_path, source):
    if source == "generated":
        ours = tmaterials.MaterialTableSet.from_directory(mcgpu_dir)
        theirs = jmaterials.MaterialTableSet.from_directory(mcgpu_dir)
    else:
        ours, theirs = tmaterials.default_material_set(), jmaterials.default_material_set()
    ours.save_npz(tmp_path / "port.npz")
    theirs.save_npz(tmp_path / "jax.npz")
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        _sets_equal(tmaterials.MaterialTableSet.from_npz(path),
                    jmaterials.MaterialTableSet.from_npz(path))
    back = tmaterials.MaterialTableSet.from_npz(tmp_path / "port.npz")
    _equal(back.densities, ours.densities)  # the file keeps float32 densities
    for a, b in zip(back.materials, ours.materials):
        _tables_equal(dataclasses.replace(a, density=b.density), b)
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert a.files == b.files
    for key in a.files:
        _equal(a[key], b[key])


def test_material_set_interop_is_the_shipped_set():
    carried = interop.material_set_from_numpy(
        [dataclasses.asdict(m) for m in jmaterials.default_material_set().materials])
    _sets_equal(carried, tmaterials.default_material_set())
    assert carried.material("h2o") == tmaterials.default_material_set().material("h2o")


def _spectrum_equal(ours, theirs):
    assert ours.name == theirs.name
    for name in ("energies", "probabilities", "cutoff", "alias"):
        _equal(getattr(ours, name), getattr(theirs, name))


def _write_spc(path, seed, terminated):
    rng = np.random.default_rng(seed)
    energies = 1e3 * np.arange(10, 10 + 40 + 1, dtype=np.float64) + rng.uniform(0, 1, 41)
    probs = rng.uniform(0.0, 1.0, 40)
    rows = ["# energy_eV probability", ""]
    rows += [f"{float(e)!r} {float(p)!r}" for e, p in zip(energies[:-1], probs)]
    rows.append(f"{float(energies[-1])!r} -1" if terminated else "")
    path.write_text("\n".join(rows) + "\n")
    return path


@pytest.mark.parametrize("terminated", [True, False], ids=["terminated", "open"])
def test_from_spc_file_matches_jax(tmp_path, terminated):
    path = _write_spc(tmp_path / "tube.spc", int(terminated), terminated)
    ours, theirs = tspectrum.Spectrum.from_spc_file(path), jspectrum.Spectrum.from_spc_file(path)
    _spectrum_equal(ours, theirs)
    assert ours.name == "tube" and ours.n_bins == 40 and len(ours.energies) == 41


@pytest.mark.parametrize("material", ["aluminium", "teflon", "h2o"])
def test_filter_and_attenuation_curve_match_jax(material):
    e_ours, mu_ours = tspectrum.attenuation_curve(material)
    e_theirs, mu_theirs = jspectrum.attenuation_curve(material)
    _equal(e_ours, e_theirs)
    _equal(mu_ours, mu_theirs)
    e_set, mu_set = tspectrum.attenuation_curve(material, tmaterials.default_material_set())
    _equal(mu_set, mu_ours)
    ours = tspectrum.default_spectrum().filter(e_ours, mu_ours, 0.25)
    theirs = jspectrum.default_spectrum().filter(e_theirs, mu_theirs, 0.25)
    _spectrum_equal(ours, theirs)
    assert ours.name.endswith("_filtered")


@pytest.mark.parametrize("titanium_mm", [0.0, 0.89])
@pytest.mark.parametrize("bowtie", [None, "half"])
def test_derive_filtered_spectrum_matches_jax(bowtie, titanium_mm):
    _spectrum_equal(tspectrum.derive_filtered_spectrum(125, titanium_mm, bowtie),
                    jspectrum.derive_filtered_spectrum(125, titanium_mm, bowtie))
    named = tspectrum.derive_filtered_spectrum(125, titanium_mm, bowtie, name="x")
    assert named.name == "x"


def test_bowtie_data_matches_jax():
    ours, theirs = tspectrum.load_bowtie_data(), jspectrum.load_bowtie_data()
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        _equal(ours[key], theirs[key])
    _equal(tspectrum.bowtie_thickness_profile("half"), jspectrum.bowtie_thickness_profile("half"))


@pytest.mark.parametrize("name", ["125kVp_0.89mmTi_half_bowtie_varian_norm", "derived"])
def test_spectrum_save_npz_cross_reads(tmp_path, name):
    if name == "derived":
        ours, theirs = tspectrum.derive_filtered_spectrum(), jspectrum.derive_filtered_spectrum()
    else:
        ours, theirs = tspectrum.default_spectrum(name), jspectrum.default_spectrum(name)
    ours.save_npz(tmp_path / "port.npz")
    theirs.save_npz(tmp_path / "jax.npz")
    for path in (tmp_path / "port.npz", tmp_path / "jax.npz"):
        _spectrum_equal(tspectrum.Spectrum.from_npz(path), jspectrum.Spectrum.from_npz(path))
    _spectrum_equal(tspectrum.Spectrum.from_npz(tmp_path / "port.npz"), ours)


def _scene(seed, shape=(7, 5, 4)):
    rng = np.random.default_rng(seed)
    mats = rng.integers(1, 23, shape).astype(np.uint8)
    dens = rng.uniform(0.0, 3.0, shape).astype(np.float32)
    dens.reshape(-1)[:3] = [0.0078125, 1.0, 0.0012]  # a tie of the 6th decimal among them
    return mats, dens


@pytest.mark.parametrize("name", ["g.vox.gz", "g.vox", "g"])
def test_export_mcgpu_geometry_matches_jax(tmp_path, name):
    mats, dens = _scene(len(name))
    compress = name != "g.vox"
    ours = tinterchange.export_mcgpu_geometry(mats, dens, (0.1, 0.2, 0.25), tmp_path / "port" / name,
                                              compress=compress)
    theirs = jinterchange.export_mcgpu_geometry(mats, dens, (0.1, 0.2, 0.25),
                                                tmp_path / "jax" / name, compress=compress)
    assert ours.name == theirs.name
    read = (lambda p: gzip.decompress(p.read_bytes())) if compress else (lambda p: p.read_bytes())
    payload = read(ours)
    assert payload == read(theirs)
    body = payload.decode().split("[END OF VXH SECTION]\n", 1)[1]
    values = native.parse_ascii_floats(body, 10_000).reshape(-1, 2)
    _equal(values[:, 0].reshape(mats.shape[::-1]).T, mats.astype(np.float64))
    # six decimals rounded half up: within half a unit of the sixth (and the
    # float64 rounding of the parsed decimal)
    assert np.abs(values[:, 1].reshape(mats.shape[::-1]).T - dens).max() <= 5e-7 + 1e-15


@pytest.mark.parametrize("angles", [(), (0.0, 12.5, 90.0)], ids=["scan", "angles"])
def test_export_mcgpu_input_matches_jax(tmp_path, angles):
    kw = dict(voxel_geometry_filepath="g.vox.gz", material_filepaths=["a.mcgpu", "b.mcgpu"],
              spectrum_filepath="tube.spc", output_folder="out", n_histories=123_456,
              source_position_cm=(17.5, -86.9, 7.1), n_projections=8, projection_angles=angles)
    ours = tinterchange.export_mcgpu_input(tmp_path / "port" / "in.in", **kw)
    theirs = jinterchange.export_mcgpu_input(tmp_path / "jax" / "in.in", **kw)
    assert ours.read_bytes() == theirs.read_bytes()


def test_render_voxel_block_is_penEasy_order():
    mats, dens = _scene(3)
    block = tinterchange.render_voxel_block(mats, dens)
    assert block == jinterchange.render_voxel_block(mats, dens)
    lines = block.splitlines()
    assert len(lines) == mats.size
    order = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1)]
    at = [0, 1, mats.shape[0], mats.shape[0] * mats.shape[1]]
    for ijk, k in zip(order, at):
        want = native.render_vox_lines_reference(mats[ijk][None], dens[ijk][None]).rstrip("\n")
        assert lines[k] == want


ASCII_CASES = {
    "empty": "",
    "comments": "# a comment line\n#another\n\n   \n",
    "report": "# MC-GPU image\n# 4 columns\n1.5 2.5e-3 -3 4\n\n5 6 7.25 8\n# end\n",
    "crlf": "1 2\r\n3\t4\r\n",
}


@pytest.mark.parametrize("case", sorted(ASCII_CASES))
@pytest.mark.parametrize("max_count", [3, 100])
def test_parse_ascii_floats_matches_jax_and_plain(case, max_count):
    text = ASCII_CASES[case]
    ours = native.parse_ascii_floats(text, max_count)
    _equal(ours, jnative.parse_ascii_floats(text, max_count))
    _equal(ours, native.parse_ascii_floats_reference(text, max_count))
    _equal(ours, native.parse_ascii_floats(text.encode(), max_count))


def test_parse_ascii_floats_random_rows():
    rng = np.random.default_rng(5)
    values = np.concatenate([rng.normal(0, 1e3, 500), rng.uniform(0, 1, 500) * 1e-30])
    text = "# header\n" + "\n".join(" ".join(repr(float(v)) for v in row)
                                    for row in values.reshape(-1, 4))
    ours = native.parse_ascii_floats(text, 2_000)
    _equal(ours, values)
    _equal(ours, jnative.parse_ascii_floats(text, 2_000))
    _equal(ours, native.parse_ascii_floats_reference(text, 2_000))


@pytest.mark.parametrize("seed", [0, 1])
def test_render_vox_lines_matches_jax_and_plain(seed):
    rng = np.random.default_rng(seed)
    mats = rng.integers(0, 256, 5_000).astype(np.uint8)
    dens = np.concatenate([rng.uniform(-5.0, 999.0, 4_980),
                           (rng.integers(-200, 200, 20) / 128.0)]).astype(np.float32)
    dens[:3] = [-0.0, 0.0, 0.0078125]
    ours = native.render_vox_lines(mats, dens)
    assert ours == jnative.render_vox_lines(mats, dens)
    assert ours == native.render_vox_lines_reference(mats, dens)
    assert native.render_vox_lines(mats[:0], dens[:0]) == ""
    for bad in (999.0, -1e9, np.nan):  # a line longer than the C++'s 16 bytes, or none
        dens[7] = bad
        with pytest.raises(ValueError, match="below 999"):
            native.render_vox_lines(mats, dens)


@pytest.mark.parametrize("scale", [100.0, 1.0])
def test_accumulate_fixed_point_matches_jax_and_plain(scale):
    rng = np.random.default_rng(int(scale))
    energies = np.concatenate([rng.uniform(0, 1.2e5, 3_000), rng.uniform(0, 5e8, 100)])
    energies = energies.astype(np.float32)
    pixels = rng.integers(-5, 70, len(energies))
    ours = native.accumulate_fixed_point(energies, pixels, 64, scale)
    _equal(ours, jnative.accumulate_fixed_point(energies, pixels, 64, scale))
    _equal(ours, native.accumulate_fixed_point_reference(energies, pixels, 64, scale))


def test_native_library_builds_into_the_port_build_dir():
    path = native.build_native()
    assert path.parent.name == "_build" and path.parent.parent.name == "cbctmc_tpu_torch"
    assert path == native.library_path() and path.exists()


COMMON_CASES = [
    ("rescale_range", lambda m: m.rescale_range(np.linspace(-2000, 5000, 50), (-1024, 3071),
                                                (0.0, 1.0))),
    ("rescale_range_clip", lambda m: m.rescale_range(np.linspace(-2000, 5000, 50), (-1024, 3071),
                                                     (1.0, -1.0), clip=True)),
    ("crop_or_pad", lambda m: m.crop_or_pad(np.arange(7 * 4 * 5.0).reshape(7, 4, 5), (4, 9, 5),
                                            pad_value=-1.0)),
    ("nearest_factor_pow_2", lambda m: np.array([m.nearest_factor_pow_2(v)
                                                 for v in (1, 7, 100, 464, 1025)]
                                                + [m.nearest_factor_pow_2(13, min_exponent=4)])),
    ("dict_collate", lambda m: m.dict_collate([{"a": np.ones(3) * i, "b": f"s{i}", "c": [i]}
                                               for i in range(3)], exclude_keys=("c",))),
    ("concat_dicts", lambda m: m.concat_dicts([{"a": [1], "b": 2}, {"a": [3, 4], "b": 5}],
                                              extend_lists=True)),
    ("get_robust_bounding_box_3d", lambda m: m.get_robust_bounding_box_3d(
        np.pad(np.random.default_rng(0).uniform(0, 1, (6, 5, 4)) > 0.3, 3), padding=1)),
    ("iec61217_to_rsp", lambda m: m.iec61217_to_rsp(np.arange(3 * 4 * 5.0).reshape(3, 4, 5))),
]


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        _equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name,call", COMMON_CASES, ids=[c[0] for c in COMMON_CASES])
def test_common_helpers_match_jax(name, call):
    _same(call(tcommon), call(jcommon))
