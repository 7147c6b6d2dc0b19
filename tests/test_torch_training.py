"""The training half of the port's DL models against the JAX package's on
the CPU: the losses and their gradients, the optax schedule and global-norm
clip, the speedup and segmentation trainers from the same parameters and
batches, the experimental nets, flax's initialisation law, the flax
checkpoint writer (read back by flax) and the quality-gated publication.

Tolerances: the losses to 1e-6 of their value (float32 reductions in
another order), their gradients to 1e-5 of the gradient's max; the schedule
to 1e-6 of the rate at every step; three optimizer updates to 1e-6 of the
rate plus an ulp of the parameter (the sum p + u rounds once). The trainers (6 steps across the L1 -> NLL switch at 3, 2 for the
segmenter): the loss of every step to 1e-5 of its value, and the
parameters after the run in units of the rates summed over the steps
(Adam's first steps move a weight by about the rate whatever the size of
its gradient, so a relative error means nothing): every kernel and live
bias within 0.05 (readings up to 0.005), the biases of convolutions that
an instance norm follows within 2. Those biases cannot change the net's
output, their gradient is rounding noise, and Adam moves them by about
the rate in the direction of that noise, so two runs can part by up to
the sum of the rates, never more than twice it. The experimental nets'
forwards to 1e-4 of max |output|, as the U-Nets' in
tests/test_torch_models.py. Checkpoints: bit-exact, and byte for byte the
file flax writes for the same tree.
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from cbctmc_tpu.models import experimental as jexperimental
from cbctmc_tpu.models import losses as jlosses
from cbctmc_tpu.models.checkpoints import load_params as jload_params
from cbctmc_tpu.models.checkpoints import publish_weights as jpublish_weights
from cbctmc_tpu.models.flex_unet import FlexUNet as JFlexUNet
from cbctmc_tpu.models.speedup_net import MCSpeedUpNet as JMCSpeedUpNet
from cbctmc_tpu.models.training import SegmentationTrainer as JSegmentationTrainer
from cbctmc_tpu.models.training import SpeedupTrainer as JSpeedupTrainer

from cbctmc_tpu_torch import interop
from cbctmc_tpu_torch.models import checkpoints, experimental, losses, training
from cbctmc_tpu_torch.models.flex_unet import FlexUNet
from cbctmc_tpu_torch.models.speedup_net import MCSpeedUpNet

from test_torch_boundary import REPO
from test_torch_models import _close, _leaves

torch.set_num_threads(4)

ASSETS = REPO / "cbctmc_tpu_torch" / "assets" / "models"


def _channels_first(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------
def _loss_inputs(name, rng):
    if name in ("dice", "segmentation"):
        logits = rng.normal(0.0, 2.0, (2, 6, 5, 4, 9)).astype(np.float32)
        labels = rng.integers(0, 8, (2, 6, 5, 4))
        target = np.eye(9, dtype=np.float32)[labels]
        target[..., 8] = rng.random((2, 6, 5, 4)) < 0.3
        if name == "dice":
            return (jax.nn.sigmoid(logits), target), (jlosses.dice_loss, losses.dice_loss)
        return (logits, target), (jlosses.segmentation_loss, losses.segmentation_loss)
    prediction = rng.gamma(2.0, 0.5, (2, 8, 8, 1)).astype(np.float32)
    target = (prediction + rng.normal(0.0, 0.2, prediction.shape)).astype(np.float32)
    if name == "l1":
        return (prediction, target), (jlosses.l1_loss, losses.l1_loss)
    variance = rng.gamma(1.0, 0.1, prediction.shape).astype(np.float32)
    variance.flat[:5] = 1e-9  # below the clamp
    return ((prediction, variance, target),
            (jlosses.gaussian_nll_loss, losses.gaussian_nll_loss))


@pytest.mark.parametrize("name", ["dice", "segmentation", "l1", "nll"])
def test_losses_and_gradients_match_jax(name):
    inputs, (jfn, fn) = _loss_inputs(name, np.random.default_rng(3))
    inputs = [np.asarray(a, np.float32) for a in inputs]
    want, want_grad = jax.value_and_grad(jfn)(*[jnp.asarray(a) for a in inputs])
    ours_in = [_channels_first(a).requires_grad_(i == 0) for i, a in enumerate(inputs)]
    got = fn(*ours_in)
    (grad,) = torch.autograd.grad(got, [ours_in[0]])
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    want_grad = np.moveaxis(np.asarray(want_grad), -1, 1)
    _close(grad.numpy(), want_grad, tol=1e-5)


# ---------------------------------------------------------------------------
# the optimizer: schedule and clip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("total_steps", [6, 40, 1200])
def test_schedule_matches_optax(total_steps):
    lr = 2e-4
    want = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=max(1, total_steps // 20),
        decay_steps=total_steps, end_value=lr * 0.02)
    ours = training.warmup_cosine_decay(lr, total_steps)
    for step in range(total_steps + 3):
        w = float(want(jnp.int32(step)))
        assert abs(float(ours(step)) - w) <= 1e-6 * w, step


def _random_tree(rng, scale):
    return {"a": {"kernel": (scale * rng.normal(size=(3, 3, 2, 4))).astype(np.float32),
                  "bias": (scale * rng.normal(size=(4,))).astype(np.float32)},
            "b": (scale * rng.normal(size=(5,))).astype(np.float32)}


@pytest.mark.parametrize("total_steps", [None, 10])
@pytest.mark.parametrize("gradient_scale", [1e-3, 10.0])  # below and above the clip
def test_optimizer_update_matches_optax(gradient_scale, total_steps):
    """Three updates of ``optax.chain(clip_by_global_norm(1), adam(...))``
    and of the port's optimizer from the same parameters and gradients."""
    rng = np.random.default_rng(5)
    params = _random_tree(rng, 1.0)
    lr = 1e-2
    schedule = optax.warmup_cosine_decay_schedule(
        init_value=lr * 0.1, peak_value=lr, warmup_steps=max(1, (total_steps or 1) // 20),
        decay_steps=total_steps or 1, end_value=lr * 0.02) if total_steps else lr
    chain = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(schedule))
    opt = training.Optimizer(lr, 1.0, total_steps)
    names = [path for path, _ in _leaves(params)]
    ours = {path: torch.from_numpy(v.copy()) for path, v in _leaves(params)}
    state, ours_state = chain.init(params), opt.init(ours)
    for _ in range(3):
        grads = _random_tree(rng, gradient_scale)
        updates, state = chain.update(grads, state, params)
        params = _numpy_tree(optax.apply_updates(params, updates))
        ours, ours_state, g_norm = opt.update(
            {path: torch.from_numpy(v) for path, v in _leaves(grads)}, ours_state, ours)
        norm = float(optax.global_norm(grads))
        assert abs(float(g_norm) - norm) <= 1e-6 * norm
        for path, want in _leaves(params):
            off = np.abs(ours[path].numpy() - want)
            assert (off <= 1e-6 * lr + np.spacing(np.abs(want))).all(), path
    assert ours_state.count == 3 and sorted(ours) == sorted(names)


# ---------------------------------------------------------------------------
# the trainers
# ---------------------------------------------------------------------------
def _speedup_batches(n, rng, size=32, batch=2):
    out = []
    for _ in range(n):
        low = rng.gamma(4.0, 0.25, (batch, size, size)).astype(np.float32)
        fp = (low + rng.normal(0.0, 0.05, low.shape)).astype(np.float32)
        high = (0.9 * low + 0.1 + rng.normal(0.0, 0.02, low.shape)).astype(np.float32)
        out.append({"input": np.stack([low, fp], -1), "target": high[..., None]})
    return out


def _segmentation_batches(n, rng, size=16):
    out = []
    for _ in range(n):
        labels = rng.integers(0, 8, (1, size, size, size))
        target = np.eye(9, dtype=np.float32)[labels]
        target[..., 8] = rng.random(labels.shape) < 0.2
        image = (labels / 8.0 + rng.normal(0.0, 0.05, labels.shape)).astype(np.float32)
        out.append({"input": image[..., None], "target": target})
    return out


def _normed_bias(path: str) -> bool:
    """A bias of a convolution that an instance norm follows."""
    return "ConvNormAct" in path and path.endswith("bias")


NETS = {
    "speedup": (lambda: JMCSpeedUpNet(mean_filter_base=4, mean_levels=2, var_filter_base=2,
                                      var_levels=1),
                lambda: MCSpeedUpNet(mean_filter_base=4, mean_levels=2, var_filter_base=2,
                                     var_levels=1)),
    "separated": (jexperimental.MCSpeedUpNetSeparated, experimental.MCSpeedUpNetSeparated),
    "segmenter": (lambda: JFlexUNet(n_classes=9, n_levels=2, ndim=3, filter_base=4),
                  lambda: FlexUNet(n_channels=1, n_classes=9, n_levels=2, ndim=3,
                                   filter_base=4)),
}


@pytest.mark.parametrize("net", ["speedup", "separated", "segmenter"])
def test_trainer_follows_jax(net, tmp_path):
    """From the same parameters and batches: the speedup trainer for 6 steps
    across the pretrain switch at 3 (on MCSpeedUpNet, on the separated
    variant with the gradient clip active), the segmentation trainer for 2;
    both with the warm-up + cosine schedule. The final checkpoint, written
    by the port, is the trained tree."""
    rng = np.random.default_rng(11)
    jmodel, model = NETS[net][0](), NETS[net][1]()
    if net == "segmenter":
        batches, n_steps = _segmentation_batches(2, rng), 2
        kwargs = dict(learning_rate=1e-3, total_steps=n_steps)
        jtrainer = JSegmentationTrainer(jmodel, **kwargs)
        trainer = training.SegmentationTrainer(model, device="cpu", output_dir=tmp_path,
                                               **kwargs)
    else:
        batches, n_steps = _speedup_batches(6, rng), 6
        kwargs = dict(learning_rate=1e-3, total_steps=n_steps,
                      grad_clip=0.05 if net == "separated" else 1.0)
        jtrainer = JSpeedupTrainer(jmodel, n_pretrain_steps=3, **kwargs)
        trainer = training.SpeedupTrainer(model, n_pretrain_steps=3, device="cpu",
                                          output_dir=tmp_path, **kwargs)
    jstate = jtrainer.init(jax.random.PRNGKey(0), batches[0])
    state = trainer.init(torch.Generator().manual_seed(0), batches[0])
    state.params = interop.state_dict_from_flax(model, _numpy_tree(jstate.params))
    want_losses, got_losses = [], []
    jstate = jtrainer.fit(jstate, iter(batches), n_steps,
                          callback=lambda s, l: want_losses.append(l))
    state = trainer.fit(state, iter(batches), n_steps, callback=lambda s, l: got_losses.append(l))
    assert state.step == n_steps
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)

    rates = sum(float(trainer.optimizer.schedule(i)) for i in range(n_steps))
    ours = dict(_leaves(trainer.flax_tree(state.params)))
    for path, want in _leaves(_numpy_tree(jstate.params)):
        off = float(np.abs(ours[path] - want).max()) / rates
        assert off <= (2.0 if _normed_bias(path) else 0.05), (path, off)
    final = dict(_leaves(checkpoints.load_flax_checkpoint(tmp_path / "final.ckpt")))
    assert sorted(final) == sorted(ours)
    for path, value in ours.items():
        np.testing.assert_array_equal(final[path], value)


def test_train_step_keeps_tf32_off_through_the_backward(monkeypatch):
    """The global cuDNN TF32 flag is read by a convolution's backward when
    it runs: inside a train step it must be off there too, and the caller's
    setting comes back after the step."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = FlexUNet(n_channels=1, n_classes=9, n_levels=1, ndim=3, filter_base=2)
    seen = []
    model.final_conv.register_full_backward_pre_hook(
        lambda *args: seen.append(torch.backends.cudnn.allow_tf32))
    trainer = training.SegmentationTrainer(model, device="cpu")
    batch = _segmentation_batches(1, np.random.default_rng(0), size=8)[0]
    state = trainer.init(torch.Generator().manual_seed(0), batch)
    trainer.fit(state, iter([batch]), 1)
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True


# ---------------------------------------------------------------------------
# the experimental nets and flax's initialisation
# ---------------------------------------------------------------------------
EXPERIMENTAL = {
    "DenseNet2D": (lambda: jexperimental.DenseNet2D(n_layers=3),
                   lambda: experimental.DenseNet2D(2, n_layers=3)),
    "ResidualDenseNet2D": (lambda: jexperimental.ResidualDenseNet2D(n_blocks=2),
                           lambda: experimental.ResidualDenseNet2D(2, n_blocks=2)),
    "ResidualDenseBlock2D": (lambda: jexperimental.ResidualDenseBlock2D(growth_rate=8),
                             lambda: experimental.ResidualDenseBlock2D(2, growth_rate=8)),
    "MCSpeedUpNetSeparated": (jexperimental.MCSpeedUpNetSeparated,
                              experimental.MCSpeedUpNetSeparated),
}


@pytest.mark.parametrize("name", sorted(EXPERIMENTAL))
def test_experimental_nets_match_flax(name):
    jmodel, model = EXPERIMENTAL[name][0](), EXPERIMENTAL[name][1]()
    x = np.random.default_rng(2).gamma(3.0, 0.3, (2, 16, 12, 2)).astype(np.float32)
    params = _numpy_tree(jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    model.load_state_dict(interop.state_dict_from_flax(model, params))
    with torch.no_grad():
        got = model(_channels_first(x)).numpy()
    _close(got, np.moveaxis(want, -1, 1))
    # and back: the port's tree is flax's, leaf for leaf
    back = dict(_leaves(interop.flax_tree_from_state_dict(model, model.state_dict())))
    want = dict(_leaves(params))
    assert sorted(back) == sorted(want)
    for path, value in want.items():
        np.testing.assert_array_equal(back[path], value)


def test_flax_init_law():
    """Each kernel of the port's init against flax's of the same net: the
    truncated normal of variance 1 / fan_in (a two-sample Kolmogorov-Smirnov
    test on the kernels scaled to unit law, and the bounds), biases zero."""
    jmodel = JFlexUNet(n_classes=2, n_levels=2, ndim=2, filter_base=32)
    model = FlexUNet(n_channels=2, n_classes=2, n_levels=2, ndim=2, filter_base=32)
    want = dict(_leaves(_numpy_tree(jmodel.init(jax.random.PRNGKey(0),
                                                jnp.ones((1, 8, 8, 2)))["params"])))
    ours = dict(_leaves(interop.flax_tree_from_state_dict(
        model, training.flax_init(model, torch.Generator().manual_seed(0)))))
    assert sorted(ours) == sorted(want)
    scaled = {"ours": [], "flax": []}
    for path, value in ours.items():
        assert value.dtype == np.float32 and value.shape == want[path].shape
        if path.endswith("bias"):
            assert not value.any() and not want[path].any()
            continue
        std = np.sqrt(1.0 / np.prod(value.shape[:-1])) / training._TRUNCATED_STD
        for key, v in (("ours", value), ("flax", want[path])):
            assert np.abs(v).max() <= 2.0 * std
            scaled[key].append(v.ravel() / std)
    ours_all, flax_all = np.concatenate(scaled["ours"]), np.concatenate(scaled["flax"])
    assert len(ours_all) > 50_000
    assert stats.ks_2samp(ours_all, flax_all).statistic < 0.01
    assert abs(ours_all.std() / training._TRUNCATED_STD - 1.0) < 0.01
    assert abs(ours_all.mean()) < 0.01


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["segmenter", "speedup"])
def test_packaged_weights_written_back_byte_for_byte(net, tmp_path):
    """The packaged flax checkpoint, carried into the port's net and back
    out through the writer, is the same file."""
    from cbctmc_tpu_torch.models.segmentation import default_segmenter_model

    path = ASSETS / net / "default.ckpt"
    model = default_segmenter_model() if net == "segmenter" else MCSpeedUpNet()
    model.load_state_dict(interop.state_dict_from_flax(
        model, checkpoints.load_flax_checkpoint(path)))
    out = checkpoints.save_params(interop.flax_tree_from_state_dict(model, model.state_dict()),
                                  tmp_path / "default.ckpt")
    assert out.read_bytes() == path.read_bytes()


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port writes from its net's parameters: the JAX
    ``load_params`` reads it into the JAX model's template, every leaf
    bit-equal, the bytes are flax's own for that tree, and the flax net's
    forward on it matches the port's."""
    model = MCSpeedUpNet(mean_filter_base=4, mean_levels=2, var_filter_base=2, var_levels=1)
    jmodel = JMCSpeedUpNet(mean_filter_base=4, mean_levels=2, var_filter_base=2, var_levels=1)
    x = np.random.default_rng(4).gamma(4.0, 0.25, (1, 32, 32, 2)).astype(np.float32)
    trainer = training.SpeedupTrainer(model, device="cpu")
    state = trainer.init(torch.Generator().manual_seed(7), {"input": x})
    tree = trainer.flax_tree(state.params)
    path = checkpoints.save_params(tree, tmp_path / "port.ckpt")
    template = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    loaded = _numpy_tree(jload_params(template, path))
    got, want = dict(_leaves(loaded)), dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype
        np.testing.assert_array_equal(got[name], value)
    assert path.read_bytes() == flax.serialization.to_bytes(loaded)
    flax_out = np.asarray(jmodel.apply({"params": loaded}, jnp.asarray(x)))
    with torch.no_grad():
        ours = trainer.trained_model(state.params)(_channels_first(x)).numpy()
    _close(ours, np.moveaxis(flax_out, -1, 1))
    # the port's own load_params: the template's keys, the file's leaves
    back = checkpoints.load_params(tree, path)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(tree)]
    for (_, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not at"):
        checkpoints.load_params({**tree, "extra": {"kernel": np.zeros(1)}}, path)


@pytest.mark.parametrize("shape,dtype", [((), "float32"), ((3,), "int32"), ((2, 300), "float64"),
                                         ((70000,), "float32"), ((1,), "uint8"), ((2,), "int8")])
def test_flax_bytes_equal_flax_to_bytes(shape, dtype):
    """The writer's msgpack forms (fix, 8/16/32-bit lengths, fixext and
    ext payloads) against flax's serializer."""
    rng = np.random.default_rng(0)
    value = np.asarray(rng.normal(size=shape) * 100).astype(dtype)
    tree = {"net": {"leaf": value, "x" * 40: np.zeros((4,), np.float32)}}
    assert checkpoints.flax_bytes(tree) == flax.serialization.to_bytes(tree)


@pytest.mark.parametrize("passes", [True, False])
def test_publish_weights_as_jax(passes, tmp_path, capsys):
    """The gate, the stamp, and an asset left untouched by a failing gate,
    as the JAX package's ``publish_weights`` leaves it."""
    ckpt = tmp_path / "final.ckpt"
    ckpt.write_bytes(b"new weights")
    report = {"mean_psnr_gain_db": 0.5 if passes else -0.5}

    def gate(r):
        return r["mean_psnr_gain_db"] > 0.0, f"gain {r['mean_psnr_gain_db']:+.2f} dB"

    results = {}
    for name, publish in (("ours", checkpoints.publish_weights), ("jax", jpublish_weights)):
        asset = tmp_path / name
        asset.mkdir()
        (asset / "default.ckpt").write_bytes(b"old weights")
        results[name] = publish(ckpt, asset, report, gate)
        results[f"{name} files"] = {p.name: p.read_bytes() for p in asset.iterdir()}
    assert results["ours"] is results["jax"] is passes
    assert results["ours files"] == results["jax files"]
    files = results["ours files"]
    assert files["default.ckpt"] == (b"new weights" if passes else b"old weights")
    if passes:
        stamp = json.loads(files["default.eval.json"])
        assert stamp["quality_gate"] == {"passed": True, "reason": "gain +0.50 dB"}
        assert checkpoints.asset_has_passing_stamp(tmp_path / "ours")
    else:
        assert "default.eval.json" not in files
        assert "NOT publishing" in capsys.readouterr().out
