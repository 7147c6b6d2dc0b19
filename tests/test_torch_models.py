"""The port's DL and scene layers against the JAX package's on the CPU: the
flax checkpoint reader, FlexUNet and the speedup net (random weights and the
packaged assets at full width), the patch-wise segmenter, speedup inference,
the material mappers, ``geometry_from_ct``, the RTK geometry export, the
logging formatter and the profiling census.

Tolerances: the checkpoint reader is bit-exact; the nets' outputs agree to
1e-4 of max |output| (float32 convolutions in another order: XLA's against
oneDNN's); the segmenter's probabilities to 1e-4 and its one-hot labels
everywhere but where the two largest probabilities lie within 1e-5; the
speedup's mean and variance to 1e-4 of their max; the mappers and the RTK
matrices are numpy and equal (densities to 1e-6, matrices to 1e-12), the XML
byte for byte."""

import gzip
import json
import logging
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.serialization
from cbctmc_tpu.geometry import mappers as jmappers
from cbctmc_tpu.models import segmentation as jsegmentation
from cbctmc_tpu.models import speedup_inference as jspeedup_inference
from cbctmc_tpu.models.checkpoints import load_params as jload_params
from cbctmc_tpu.models.flex_unet import FlexUNet as JFlexUNet
from cbctmc_tpu.models.speedup_net import MCSpeedUpNet as JMCSpeedUpNet
from cbctmc_tpu.pipeline import patient as jpatient
from cbctmc_tpu.recon import rtk_interop as jrtk
from cbctmc_tpu.utils import logging as jlogging
from cbctmc_tpu.utils.io import write_image as jwrite_image

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.geometry import mappers
from cbctmc_tpu_torch.models import segmentation, speedup_inference
from cbctmc_tpu_torch.models.checkpoints import asset_has_passing_stamp, load_flax_checkpoint
from cbctmc_tpu_torch.models.flex_unet import FlexUNet
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet, sample_projection
from cbctmc_tpu_torch.pipeline import patient
from cbctmc_tpu_torch.recon import rtk_interop
from cbctmc_tpu_torch.utils import logging as tlogging
from cbctmc_tpu_torch.utils import profiling

from test_torch_boundary import REPO

torch.set_num_threads(4)

ASSETS = REPO / "cbctmc_tpu_torch" / "assets" / "models"
NET_TOL = 1e-4  # of max |output|


def _close(ours, theirs, tol=NET_TOL):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    scale = float(np.abs(theirs).max())
    err = float(np.abs(ours - theirs).max())
    assert err <= tol * scale, f"max |diff| {err} > {tol} x {scale}"


def _leaves(tree, path=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, f"{path}/{key}")
        else:
            yield f"{path}/{key}", value


# ---------------------------------------------------------------------------
# the checkpoint reader
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net,n_leaves", [("segmenter", 36), ("speedup", 56)])
def test_load_flax_checkpoint_equals_flax_restore(net, n_leaves):
    path = ASSETS / net / "default.ckpt"
    ours = dict(_leaves(load_flax_checkpoint(path)))
    theirs = dict(_leaves(flax.serialization.msgpack_restore(path.read_bytes())))
    assert sorted(ours) == sorted(theirs) and len(ours) == n_leaves
    for name, value in theirs.items():
        assert ours[name].dtype == value.dtype and ours[name].shape == value.shape, name
        assert ours[name].tobytes() == value.tobytes(), name
        assert ours[name].flags.writeable
    assert asset_has_passing_stamp(ASSETS / net)


def _ext(code: int, payload: bytes) -> bytes:
    return b"\xc7" + struct.pack(">Bb", len(payload), code) + payload


_GOOD_LEAF = flax.serialization.msgpack_serialize({"w": np.arange(3, dtype=np.float32)})


@pytest.mark.parametrize("raw,match", [
    (b"\x81\xa1w\xca\x3f\x80\x00\x00", "0xca"),  # a float32 leaf
    (b"\x81\xa1w\xc0", "0xc0"),  # nil
    (b"\x81\xa1w" + _ext(2, b"\x93\x90\xa9complex64\xc4\x00"), "extension type 2"),
    (b"\x81\x01\x01", "not a string"),  # an integer key
    (_GOOD_LEAF + b"\x00", "bytes after the tree"),
    (_GOOD_LEAF[:-2], "ends inside"),
])
def test_load_flax_checkpoint_refuses_what_it_does_not_know(raw, match, tmp_path):
    path = tmp_path / "bad.ckpt"
    path.write_bytes(raw)
    with pytest.raises(ValueError, match=match):
        load_flax_checkpoint(path)
    good = tmp_path / "good.ckpt"
    good.write_bytes(_GOOD_LEAF)
    np.testing.assert_array_equal(load_flax_checkpoint(good)["w"], np.arange(3))


# ---------------------------------------------------------------------------
# FlexUNet and the speedup net against flax apply
# ---------------------------------------------------------------------------
def _flax_apply(model, params, x_channels_last):
    out = jax.jit(model.apply)({"params": params}, jnp.asarray(x_channels_last))
    return jax.tree_util.tree_map(np.asarray, out)


def _torch_apply(model, x_channels_last):
    x = torch.from_numpy(np.moveaxis(x_channels_last, -1, 1).copy())
    with torch.inference_mode():
        out = model.eval()(x)
    out = out[0] if isinstance(out, tuple) else out
    return np.moveaxis(out.numpy(), 1, -1)


@pytest.mark.parametrize("kw,shape", [
    (dict(n_classes=3, n_levels=2, ndim=2, filter_base=8), (2, 16, 24, 3)),
    (dict(n_classes=2, n_levels=3, ndim=2, filter_base=4, skip_connections=False), (1, 24, 16, 2)),
    (dict(n_classes=9, n_levels=2, ndim=3, n_filters=[8, 6, 10, 12, 8, 4]), (1, 8, 12, 16, 1)),
    (dict(n_classes=1, n_levels=1, ndim=3, filter_base=6, return_bottleneck=True), (2, 6, 8, 4, 2)),
])
def test_flex_unet_matches_flax(kw, shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    jmodel = JFlexUNet(**kw)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    # biases away from 0, so a bias carried to the wrong place shows
    params = jax.tree_util.tree_map(lambda p: p + 0.1 if p.ndim == 1 else p, params)
    ours = FlexUNet(n_channels=shape[-1], **kw)
    tree = jax.tree_util.tree_map(np.asarray, params)
    ours.load_state_dict(interop.state_dict_from_flax(ours, tree))
    theirs = _flax_apply(jmodel, params, x)
    if kw.get("return_bottleneck"):
        out, bottleneck = theirs
        with torch.inference_mode():
            _, ours_bottleneck = ours.eval()(torch.from_numpy(np.moveaxis(x, -1, 1).copy()))
        _close(np.moveaxis(ours_bottleneck.numpy(), 1, -1), bottleneck)
        theirs = out
    _close(_torch_apply(ours, x), theirs)


def test_flex_unet_state_dict_refuses_an_unknown_name():
    unet = FlexUNet(n_channels=1, n_classes=1, n_levels=1, ndim=2, filter_base=2)
    with pytest.raises(ValueError, match="no counterpart in FlexUNet"):
        interop.state_dict_from_flax(unet, {"Dense_0": {"kernel": np.zeros((2, 2))}})
    with pytest.raises(ValueError, match="MCSpeedUpNet: no flax parameter mean_net/Conv_0"):
        interop.state_dict_from_flax(MCSpeedUpNet(), {"mean_net": {}})


def test_segmenter_asset_matches_flax_at_full_width():
    """The packaged segmenter (4 levels, 32 filters, 9 classes) on one
    32 x 32 x 16 patch: raw logits, so a transposed kernel shows."""
    tree = load_flax_checkpoint(ASSETS / "segmenter" / "default.ckpt")
    ours = segmentation.default_segmenter_model()
    ours.load_state_dict(interop.state_dict_from_flax(ours, tree))
    x = np.random.default_rng(2).random((1, 32, 32, 16, 1)).astype(np.float32)
    jmodel = jsegmentation.default_segmenter_model()
    theirs = _flax_apply(jmodel, jax.tree_util.tree_map(jnp.asarray, tree), x)
    _close(_torch_apply(ours, x), theirs)


def test_speedup_asset_matches_flax_at_full_width():
    """The packaged speedup net (64 / 16 filters) on a 2 x 64 x 64 x 2 batch."""
    tree = load_flax_checkpoint(ASSETS / "speedup" / "default.ckpt")
    ours = MCSpeedUpNet()
    ours.load_state_dict(interop.state_dict_from_flax(ours, tree))
    rng = np.random.default_rng(3)
    x = np.stack([rng.gamma(4.0, 0.25, (2, 64, 64)), rng.random((2, 64, 64))], -1)
    x = x.astype(np.float32)
    theirs = _flax_apply(JMCSpeedUpNet(), jax.tree_util.tree_map(jnp.asarray, tree), x)
    _close(_torch_apply(ours, x), theirs)


# ---------------------------------------------------------------------------
# the segmenter and the speedup inference against the JAX package's
# ---------------------------------------------------------------------------
def _hu_volume(shape=(40, 40, 24), seed=4):
    """Air, a body of soft tissue with a bone and a lung block, and noise."""
    rng = np.random.default_rng(seed)
    ct = np.full(shape, -1000.0, np.float32)
    ct[6:34, 8:32, 2:22] = 40.0
    ct[16:24, 14:22, 6:18] = 700.0
    ct[8:15, 10:18, 4:20] = -820.0
    return ct + rng.normal(scale=30.0, size=shape).astype(np.float32)


def _segmenters(patch=(32, 32, 16), overlap=0.5):
    path = ASSETS / "segmenter" / "default.ckpt"
    model = segmentation.default_segmenter_model()
    model.load_state_dict(interop.state_dict_from_flax(model, load_flax_checkpoint(path)))
    ours = segmentation.MCSegmenter(model=model, patch_shape=patch, patch_overlap=overlap,
                                    device="cpu")
    jmodel = jsegmentation.default_segmenter_model()
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 32, 1)))["params"]
    theirs = jsegmentation.MCSegmenter(model=jmodel, params=jload_params(template, path),
                                       patch_shape=patch, patch_overlap=overlap)
    return ours, theirs


def test_segment_matches_jax():
    ct = _hu_volume()
    ours, theirs = _segmenters()
    assert len(list(segmentation.ordered_patch_slicings(ct.shape, (32, 32, 16), 0.5))) == 8
    pred, raw = ours.segment(ct)
    jpred, jraw = theirs.segment(ct)
    assert pred.dtype == jpred.dtype == np.uint8 and pred.shape == (9, 40, 40, 24)
    np.testing.assert_allclose(raw, jraw, rtol=0, atol=1e-4)
    top2 = np.sort(jraw[: segmentation.N_SOFTMAX_LABELS], axis=0)[-2:]
    tie = (top2[1] - top2[0]) <= 1e-5
    vessel_tie = np.abs(jraw[segmentation.N_SOFTMAX_LABELS] - 0.5) <= 1e-5
    differ = (pred != jpred)
    assert not differ[: segmentation.N_SOFTMAX_LABELS, ~tie].any()
    assert not differ[segmentation.N_SOFTMAX_LABELS, ~vessel_tie].any()
    # a volume smaller than the patch is padded and cropped back
    small = ct[:20, :24, :12]
    np.testing.assert_allclose(ours.segment(small)[1], theirs.segment(small)[1], atol=1e-4)


def test_segmentation_helpers_match_jax():
    for shape, patch, overlap in (((70, 64, 40), (32, 32, 32), 0.5), ((9, 30, 5), (4, 8, 8), 0.25)):
        assert list(segmentation.ordered_patch_slicings(shape, patch, overlap)) == \
            list(jsegmentation.ordered_patch_slicings(shape, patch, overlap))
    rng = np.random.default_rng(5)
    ours, theirs = segmentation.PatchStitcher((2, 6, 6)), jsegmentation.PatchStitcher((2, 6, 6))
    for sl in ((slice(None), slice(0, 4), slice(0, 4)), (slice(None), slice(2, 6), slice(1, 5))):
        patch = rng.random((2, 4, 4)).astype(np.float32)
        ours.add_patch(patch, sl)
        theirs.add_patch(patch, sl)
    np.testing.assert_array_equal(ours.calculate_mean(), theirs.calculate_mean())
    np.testing.assert_array_equal(ours.calculate_variance(), theirs.calculate_variance())
    assert segmentation.LABELS == jsegmentation.LABELS
    assert segmentation.get_label_index("lung") == jsegmentation.get_label_index("lung") == 6
    np.testing.assert_array_equal(
        segmentation.rescale_range([-2000.0, 0.0, 5000.0], (-1024, 3071), (0, 1), clip=True),
        jsegmentation.rescale_range([-2000.0, 0.0, 5000.0], (-1024, 3071), (0, 1), clip=True))


@pytest.fixture(scope="module")
def speedups():
    path = ASSETS / "speedup" / "default.ckpt"
    ours = speedup_inference.MCSpeedup.from_checkpoint(path, device="cpu")
    theirs = jspeedup_inference.MCSpeedup.from_checkpoint(path, example_shape=(1, 32, 48))
    return ours, theirs


def _projections(shape=(3, 37, 50), seed=6):
    rng = np.random.default_rng(seed)
    low = rng.gamma(6.0, 40.0, shape).astype(np.float32)
    fp = rng.random(shape).astype(np.float32) * 300.0
    return low, fp


@pytest.mark.parametrize("with_fp", [False, True])
def test_speedup_predict_matches_jax(with_fp, speedups):
    """Sizes not multiples of 16 (the edges keep the input, zero variance),
    three projections in batches of two."""
    ours, theirs = speedups
    low, fp = _projections()
    fp = fp if with_fp else None
    mean, var = ours.predict(low, fp, batch_size=2)
    jmean, jvar = theirs.predict(low, fp, batch_size=2)
    _close(mean, jmean)
    _close(var, jvar)
    np.testing.assert_array_equal(mean[:, 32:, :], low[:, 32:, :])
    np.testing.assert_array_equal(mean[:, :, 48:], low[:, :, 48:])
    assert (var[:, 32:, :] == 0).all() and (var[:, :, 48:] == 0).all()


def test_match_mean_std_matches_jax():
    low, fp = _projections((2, 8, 12))
    ours = speedup_inference.match_mean_std(torch.from_numpy(fp), torch.from_numpy(low))
    theirs = jspeedup_inference.match_mean_std(jnp.asarray(fp), jnp.asarray(low))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5)


def test_speedup_execute_draws_from_its_seed(speedups):
    ours, _ = speedups
    low, fp = _projections((2, 32, 32))
    mean, var, sample = ours.execute(low, fp, seed=3)
    z = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3)).numpy()
    np.testing.assert_allclose(sample, np.maximum(mean + z * np.sqrt(var), 0.0), rtol=1e-6)
    again = ours.execute(low, fp, seed=3)[2]
    np.testing.assert_array_equal(again, sample)
    assert not np.array_equal(ours.execute(low, fp, seed=4)[2], sample)
    assert (sample >= 0).all()


def test_sample_projection_clips_at_zero():
    mean = torch.tensor([0.0, 1.0, 2.0])
    out = sample_projection(torch.Generator().manual_seed(0), mean, torch.full((3,), 100.0))
    assert (out >= 0).all() and (out == 0).any()


# ---------------------------------------------------------------------------
# the material mappers and geometry_from_ct
# ---------------------------------------------------------------------------
def _segmentations(shape, seed=7):
    rng = np.random.default_rng(seed)
    names = ("body", "bone", "muscle", "fat", "liver", "stomach", "lung", "lung_vessel")
    segs = {n: (rng.random(shape) > 0.6).astype(np.uint8) for n in names}
    segs["body"][2:-2, 2:-2, 2:-2] = 1
    return {f"{n}_segmentation": s for n, s in segs.items()}


def test_mappers_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    shape = (12, 10, 9)
    ct = rng.uniform(-1100.0, 1200.0, shape).astype(np.float32)
    segs = _segmentations(shape)
    mask = segs["bone_segmentation"] > 0
    np.testing.assert_array_equal(mappers._binary_erosion_6(mask),
                                  jmappers._binary_erosion_6(mask))
    # one segmentation from a file, one missing (its mapper skipped)
    jwrite_image(segs["liver_segmentation"], tmp_path / "liver.nii.gz")
    segs["liver_segmentation"] = tmp_path / "liver.nii.gz"
    segs["stomach_segmentation"] = None
    ours = mappers.MaterialMapperPipeline.create_default_pipeline(**segs).execute(ct)
    theirs = jmappers.MaterialMapperPipeline.create_default_pipeline(**segs).execute(ct)
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_allclose(ours[1], theirs[1], rtol=0, atol=1e-6)
    assert len(np.unique(ours[0])) >= 8


def _ct_file(tmp_path, ct, spacing=(1.0, 1.0, 1.0)):
    path = tmp_path / "ct.mha"
    jwrite_image(ct, path, spacing=spacing)
    return path


def test_geometry_from_ct_with_given_segmentations_matches_jax(tmp_path):
    """Without weights the segmentations passed in are used (the CT at
    1.5 mm, resampled to 1 mm first)."""
    rng = np.random.default_rng(9)
    ct = rng.uniform(-1100.0, 1200.0, (10, 8, 6)).astype(np.float32)
    path = _ct_file(tmp_path, ct, spacing=(1.5, 1.5, 1.5))
    segs = _segmentations((15, 12, 9))
    ours = patient.geometry_from_ct(path, device="cpu", **segs)
    theirs = jpatient.geometry_from_ct(path, **segs)
    np.testing.assert_array_equal(ours.materials, theirs.materials)
    np.testing.assert_allclose(ours.densities, theirs.densities, rtol=0, atol=1e-6)
    assert ours.image_spacing == theirs.image_spacing == (1.0, 1.0, 1.0)
    np.testing.assert_array_equal(
        patient.resample_to_spacing(ct, (1.5, 1.5, 1.5)),
        jpatient.resample_to_spacing(ct, (1.5, 1.5, 1.5)))


def test_geometry_from_ct_with_the_asset_segmenter_matches_jax(tmp_path):
    path = _ct_file(tmp_path, _hu_volume())
    weights = ASSETS / "segmenter" / "default.ckpt"
    kw = dict(segmenter_weights=weights, patch_shape=(32, 32, 16), patch_overlap=0.5)
    lung = np.zeros((40, 40, 24), np.uint8)
    lung[30:36, 30:36, 10:14] = 1  # a segmentation passed in wins over the segmenter's
    ours = patient.geometry_from_ct(path, device="cpu", lung_segmentation=lung, **kw)
    theirs = jpatient.geometry_from_ct(path, lung_segmentation=lung, **kw)
    np.testing.assert_array_equal(ours.materials, theirs.materials)
    np.testing.assert_allclose(ours.densities, theirs.densities, rtol=0, atol=1e-6)
    assert len(np.unique(ours.materials)) >= 3


# ---------------------------------------------------------------------------
# RTK geometry export, logging, profiling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(n_projections=7, start_angle=90.0),
    dict(n_projections=5),
    dict(n_projections=3, detector_offset_x=0.0, detector_offset_y=1.25, arc=200.0),
    dict(n_projections=4, angles_deg=[0.0, 33.3, 400.0, -10.0], source_to_isocenter=800.0),
])
def test_rtk_geometry_matches_jax(kw, tmp_path):
    ours, theirs = rtk_interop.create_rtk_geometry(**kw), jrtk.create_rtk_geometry(**kw)
    np.testing.assert_allclose(ours.matrices(), theirs.matrices(), rtol=0, atol=1e-12)
    rtk_interop.save_rtk_geometry_xml(ours, tmp_path / "ours.xml")
    jrtk.save_rtk_geometry_xml(theirs, tmp_path / "theirs.xml")
    assert (tmp_path / "ours.xml").read_bytes() == (tmp_path / "theirs.xml").read_bytes()
    # the offsets and angles a circular geometry may carry
    full = dict(source_offset_x=1.0, source_offset_y=-2.0, in_plane_angle_deg=3.0,
                out_of_plane_angle_deg=-4.0)
    a = rtk_interop.RTKCircularGeometry(ours.gantry_angles_deg, **full)
    b = jrtk.RTKCircularGeometry(theirs.gantry_angles_deg, **full)
    np.testing.assert_allclose(a.matrices(), b.matrices(), rtol=0, atol=1e-12)
    rtk_interop.save_rtk_geometry_xml(a, tmp_path / "a.xml")
    jrtk.save_rtk_geometry_xml(b, tmp_path / "b.xml")
    assert (tmp_path / "a.xml").read_bytes() == (tmp_path / "b.xml").read_bytes()


def test_fancy_formatter_matches_jax():
    record = logging.LogRecord("cbctmc", logging.WARNING, __file__, 1, "x" * 50, None, None)
    for kw in (dict(), dict(max_message_length=20, colors=False)):
        assert tlogging.FancyFormatter(**kw).format(record) == \
            jlogging.FancyFormatter(**kw).format(record)

    class Thing(tlogging.LoggerMixin):
        pass

    assert Thing().logger.name == f"{__name__}.test_fancy_formatter_matches_jax.<locals>.Thing"
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    try:
        tlogging.init_fancy_logging(logging.DEBUG, max_message_length=30)
        assert root.level == logging.DEBUG and len(root.handlers) == 1
        assert root.handlers[0].formatter.max_message_length == 30
    finally:
        root.handlers, root.level = handlers, level


def _chrome_trace():
    return {"traceEvents": [
        {"ph": "X", "name": "kernel_a", "dur": 1500, "ts": 0},
        {"ph": "X", "name": "kernel_b", "dur": 200, "ts": 10},
        {"ph": "X", "name": "kernel_a", "dur": 500, "ts": 20},
        {"ph": "i", "name": "kernel_a", "ts": 30},  # an instant event: not counted
        {"ph": "X", "name": "kernel_c", "ts": 40},  # no duration: not counted
        {"ph": "B", "name": "kernel_b", "ts": 50},
    ]}


@pytest.mark.parametrize("zipped", [False, True])
def test_kernel_census_of_a_chrome_trace(zipped, tmp_path):
    raw = json.dumps(_chrome_trace()).encode()
    path = tmp_path / ("trace.json.gz" if zipped else "trace.json")
    path.write_bytes(gzip.compress(raw) if zipped else raw)
    assert profiling.kernel_census(str(path)) == [
        {"name": "kernel_a", "total_ms": 2.0, "count": 2},
        {"name": "kernel_b", "total_ms": 0.2, "count": 1},
    ]
    assert profiling.kernel_census(str(path), top=1) == [
        {"name": "kernel_a", "total_ms": 2.0, "count": 2}]


def test_profile_projection_step_on_the_cpu(tmp_path):
    x = torch.ones(64, 64)
    rows, path = profiling.profile_projection_step(lambda: (x @ x).sum(), device="cpu")
    assert path.endswith("trace.json")
    names = [r["name"] for r in rows]
    assert "aten::mm" in names or "aten::matmul" in names
    assert all(r["count"] >= 1 and r["total_ms"] >= 0 for r in rows)
