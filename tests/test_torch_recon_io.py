"""The port's file I/O, analysis helpers and reconstruction entry points
against the JAX package, on the CPU: image files written by either package
and read by the other; NCC / PSNR / RMSE, AMPD peaks and respiratory
binning (numpy copies: equal results); ``reconstruct_3d`` and
``reconstruct_4d`` from a projection stack that the JAX package's
``write_image`` wrote, their volumes and yaml against the JAX entry points'.

Tolerances. I/O, metrics, peaks and binning: exact. ``reconstruct_3d``:
FDK's filter runs through ``torch.fft`` and ``jnp.fft`` (PocketFFT both,
different summation order) and the backprojections agree to rounding
(tests/test_torch_fdk.py): 1e-5 of the volume's maximum. ``reconstruct_4d``:
ROOSTER's bound of tests/test_torch_rooster.py, 1e-4."""

import zlib

import numpy as np
import pytest
import torch
import yaml

from cbctmc_tpu.analysis import binning as jbinning
from cbctmc_tpu.analysis import metrics as jmetrics
from cbctmc_tpu.analysis import peaks as jpeaks
from cbctmc_tpu.pipeline import reconstruction as jrecon
from cbctmc_tpu.recon.geometry import ConeBeamGeometry as JaxGeometry
from cbctmc_tpu.recon.joseph import project_forward
from cbctmc_tpu.recon.rooster import RoosterParameters as JaxRoosterParameters
from cbctmc_tpu.utils import io as jio
from cbctmc_tpu_torch.analysis import binning as tbinning
from cbctmc_tpu_torch.analysis import metrics as tmetrics
from cbctmc_tpu_torch.analysis import peaks as tpeaks
from cbctmc_tpu_torch.pipeline import reconstruction as trecon
from cbctmc_tpu_torch.recon.geometry import ConeBeamGeometry
from cbctmc_tpu_torch.recon.rooster import RoosterParameters
from cbctmc_tpu_torch.utils import io as tio

torch.set_num_threads(2)

GEOM = dict(sad=400.0, sdd=600.0, n_pixels_u=64, n_pixels_v=4, pixel_size_u=6.0,
            pixel_size_v=8.0, detector_offset_u=0.0)
FDK_RTOL = 1e-5
ROOSTER_RTOL = 1e-4


def _rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _breathing(n: int, cycles: float = 4.0) -> np.ndarray:
    t = np.arange(n) / n
    return (np.cos(2 * np.pi * cycles * t) ** 4 + 0.02 * np.sin(2 * np.pi * 11 * t)).astype(
        np.float64)


@pytest.mark.parametrize("name", ["a.mha", "b.mhd", "c.nii", "d.nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.uint8])
@pytest.mark.parametrize("writer, reader", [("jax", "port"), ("port", "jax")])
def test_image_files_cross_read(tmp_path, name, dtype, writer, reader):
    rng = np.random.default_rng(0)
    arr = (rng.random((7, 5, 3)) * 100).astype(dtype)
    write = {"jax": jio.write_image, "port": tio.write_image}[writer]
    read = {"jax": jio.read_image, "port": tio.read_image}[reader]
    write(arr, tmp_path / name, spacing=(0.5, 1.25, 2.0), origin=(-1.0, 2.0, 3.5))
    got, meta = read(tmp_path / name)
    want, want_meta = {"jax": jio.read_image, "port": tio.read_image}[writer](tmp_path / name)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
    assert got.dtype == arr.dtype
    assert meta.keys() == want_meta.keys()
    for k in meta:
        np.testing.assert_array_equal(np.asarray(meta[k]), np.asarray(want_meta[k]))


def test_4d_mha_and_uncompressed_files_cross_read(tmp_path):
    arr = np.random.default_rng(1).random((4, 3, 5, 2)).astype(np.float32)
    tio.write_image(arr, tmp_path / "v.mha", spacing=(1.0, 2.0, 3.0, 1.0))
    np.testing.assert_array_equal(jio.read_image(tmp_path / "v.mha")[0], arr)
    jio.write_mha(arr[..., 0], tmp_path / "raw.mha", compress=False)
    with open(tmp_path / "raw.mha", "rb") as f:
        head = f.read(400)
    assert b"CompressedData = False" in head
    np.testing.assert_array_equal(tio.read_mha(tmp_path / "raw.mha")[0], arr[..., 0])
    with pytest.raises(ValueError, match="Unsupported"):
        tio.write_image(arr, tmp_path / "v.png")


def test_chunked_deflate_reads_as_one_zlib_stream(tmp_path, monkeypatch):
    """A MetaImage payload past the threshold is deflated in chunks on
    threads (thresholds lowered here: 288,000 bytes in 9 chunks, the last
    one short): both packages read it back equal and it inflates as one
    zlib stream of CompressedDataSize bytes. Below the threshold the port
    writes the file byte for byte as the JAX package does."""
    arr = np.random.default_rng(2).random((40, 30, 20, 3)).astype(np.float32)
    monkeypatch.setattr(tio, "_PARALLEL_DEFLATE_BYTES", 1 << 16)
    monkeypatch.setattr(tio, "_DEFLATE_CHUNK_BYTES", 1 << 15)
    monkeypatch.setattr(tio, "_DEFLATE_THREADS", 2)
    tio.write_image(arr, tmp_path / "chunked.mha")
    np.testing.assert_array_equal(jio.read_image(tmp_path / "chunked.mha")[0], arr)
    np.testing.assert_array_equal(tio.read_image(tmp_path / "chunked.mha")[0], arr)
    data = (tmp_path / "chunked.mha").read_bytes()
    end = b"ElementDataFile = LOCAL\n"
    payload = data[data.index(end) + len(end):]
    assert f"CompressedDataSize = {len(payload)}\n".encode() in data
    assert zlib.decompress(payload) == np.ascontiguousarray(np.transpose(arr)).tobytes()
    monkeypatch.undo()
    tio.write_image(arr, tmp_path / "port.mha")
    jio.write_image(arr, tmp_path / "jax.mha")
    assert (tmp_path / "port.mha").read_bytes() == (tmp_path / "jax.mha").read_bytes()


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.random((16, 16)), rng.random((16, 16))
    for name in ("normalized_cross_correlation", "psnr", "rmse"):
        assert getattr(tmetrics, name)(a, b) == getattr(jmetrics, name)(a, b)
    assert tmetrics.psnr(a, a) == jmetrics.psnr(a, a) == float("inf")
    assert tmetrics.normalized_cross_correlation(a, np.ones_like(a)) == 0.0


@pytest.mark.parametrize("scale", [None, 10])
def test_peaks_match_jax(scale):
    x = _breathing(300, cycles=6.0)
    np.testing.assert_array_equal(tpeaks.find_peaks(x, scale), jpeaks.find_peaks(x, scale))


def test_binning_matches_jax():
    sig = _breathing(600, cycles=10.0)
    np.testing.assert_array_equal(tbinning.calculate_amplitude_bins(sig, 10),
                                  jbinning.calculate_amplitude_bins(sig, 10))
    np.testing.assert_array_equal(tbinning.calculate_phase_bins(sig, 10),
                                  jbinning.calculate_phase_bins(sig, 10))
    np.testing.assert_array_equal(tbinning.scale_signal_to_phase_for_rooster(sig),
                                  jbinning.scale_signal_to_phase_for_rooster(sig))
    np.testing.assert_array_equal(tbinning.calculate_median_cycle(sig),
                                  jbinning.calculate_median_cycle(sig))
    for got, want in zip(tbinning.calculate_pseudo_average_phase(sig, n_bins=10),
                         jbinning.calculate_pseudo_average_phase(sig, n_bins=10)):
        np.testing.assert_array_equal(got, want)
    assert (dataclasses_dict(tbinning.calculate_respiratory_statistics(sig, 25.0))
            == dataclasses_dict(jbinning.calculate_respiratory_statistics(sig, 25.0)))


def dataclasses_dict(obj) -> dict:
    import dataclasses

    return dataclasses.asdict(obj)


@pytest.fixture(scope="module")
def stack_file(tmp_path_factory):
    """24 views of tests/test_pipeline.py's cylinder, projected by the JAX
    projector and written by the JAX package's ``write_image`` in the
    artifact layout (rows flipped, [u, v, P])."""
    folder = tmp_path_factory.mktemp("stack")
    coords = (np.arange(48) - 23.5) * 4.0
    x, y = np.meshgrid(coords, coords, indexing="ij")
    vol = np.repeat(((((x - 12.0) ** 2 + y**2) <= 40.0**2) * 0.02).astype(np.float32)[:, :, None],
                    4, 2)
    angles = 270.0 + np.arange(24) * 15.0
    proj = project_forward(vol, JaxGeometry(**GEOM), angles, volume_spacing=(4.0,) * 3,
                           step_mm=2.0)
    path = folder / "projections.mha"
    jio.write_image(np.transpose(proj[:, ::-1, :], (2, 1, 0)), path, spacing=(6.0, 8.0, 1.0))
    return path


def test_load_projection_stack_matches_jax(stack_file):
    got, meta = trecon.load_projection_stack_for_recon(stack_file)
    want, want_meta = jrecon.load_projection_stack_for_recon(stack_file)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (24, 4, 64)
    np.testing.assert_array_equal(meta["spacing"], want_meta["spacing"])


def _read_outputs(out):
    volume, meta = tio.read_image(out)
    with open(out.with_suffix(".yaml")) as f:
        params = yaml.safe_load(f)
    return volume, meta, params


def test_reconstruct_3d_matches_jax(stack_file, tmp_path):
    kw = dict(dimension=(48, 4, 48), spacing=(4.0, 4.0, 4.0), hann_y=0.0, use_wpc=True)
    want_out = jrecon.reconstruct_3d(stack_file, output_folder=tmp_path / "jax",
                                     geometry=JaxGeometry(**GEOM), **kw)
    got_out = trecon.reconstruct_3d(stack_file, output_folder=tmp_path / "port",
                                    geometry=ConeBeamGeometry(**GEOM), device="cpu", **kw)
    assert got_out.name == want_out.name == "recon_fdk3d.mha"
    got, meta, params = _read_outputs(got_out)
    want, want_meta, want_params = _read_outputs(want_out)
    assert got.shape == want.shape == (48, 48, 4)
    assert _rel_err(got, want) <= FDK_RTOL
    for k in ("spacing", "origin"):
        np.testing.assert_array_equal(meta[k], want_meta[k])
    assert params == want_params


def test_reconstruct_4d_matches_jax(stack_file, tmp_path):
    kw = dict(amplitude_signal=_breathing(24, cycles=3.0), dimension=(48, 4, 48),
              spacing=(4.0, 4.0, 4.0))
    par = dict(n_phases=3, n_iterations=2, n_data_subiterations=2, n_tv_iterations=3,
               projector="joseph")
    want_out = jrecon.reconstruct_4d(stack_file, output_folder=tmp_path / "jax",
                                     geometry=JaxGeometry(**GEOM),
                                     parameters=JaxRoosterParameters(**par), **kw)
    got_out = trecon.reconstruct_4d(stack_file, output_folder=tmp_path / "port",
                                    geometry=ConeBeamGeometry(**GEOM),
                                    parameters=RoosterParameters(**par), device="cpu", **kw)
    got, meta, params = _read_outputs(got_out)
    want, want_meta, want_params = _read_outputs(want_out)
    assert got.shape == want.shape == (48, 48, 4, 3)
    assert np.isfinite(got).all()
    assert _rel_err(got, want) <= ROOSTER_RTOL
    np.testing.assert_array_equal(meta["spacing"], want_meta["spacing"])
    assert params == want_params
    np.testing.assert_array_equal(np.loadtxt(tmp_path / "port" / "signal_phase.txt"),
                                  np.loadtxt(tmp_path / "jax" / "signal_phase.txt"))
    # the checkpoint is removed on success
    assert not list((tmp_path / "port").glob("*.ckpt*"))


def test_reconstruct_4d_needs_a_signal(stack_file, tmp_path):
    with pytest.raises(ValueError, match="amplitude_signal or phase_signal"):
        trecon.reconstruct_4d(stack_file, output_folder=tmp_path, device="cpu")
