"""The port's losses, prompt-driven norms and context-aware classifier
against the JAX package on the CPU: ``SmoothCELoss``, ``BinaryFocalLoss``,
``FocalLoss``, ``DiceLoss`` and ``LovaszLoss`` (values and gradients, with
padded and ignored points, Lovasz also with forced ties),
``PDMaskedBatchNorm`` and ``PDLayerNorm`` (train and eval, decoupled and
not, adaptive), and ``CAC-v1m1`` over a small PT-v2m2 (the eval logits;
in training the five loss entries and the whole gradient).

Inputs come from a numpy seed.  The JAX side runs unfused
(``FUSED_GVA = "off"``) with the exact kNN, in f32.  Tolerances: a loss
and its gradient rtol 1e-5 (a gradient also atol 1e-4 of its max: the
softmax's backward cancels terms, and entries a thousand times below the
largest carry its f32 noise), a
norm rtol 1e-4 / atol 1e-5, the CAC logits 1e-4 x max |logit|, its losses
rtol 1e-4, its whole gradient against JAX's and against float64 as
``assert_gradient_triple`` holds a network's (0.25 of a tensor's max,
0.05 in L2).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models import norm as jnorm
from pointcloudpdf_tpu.models.losses import LOSSES as JAX_LOSSES
from pointcloudpdf_tpu.models.point_transformer_v2 import ptv2 as jptv2
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models import norm as pnorm
from pointcloudpdf_tpu_torch.models.losses import LOSSES
from pointcloudpdf_tpu_torch.models.point_transformer_v2 import ptv2 as port
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree

from test_torch_layer import randomise_bn
from test_torch_ptv2 import cloud
from test_torch_st import japply, jinit, knn_tie_gap, load_from_jax, tt
from test_torch_train import GRADIENT_TOL, GRADIENT_TOL_WHOLE

torch.set_num_threads(1)

RTOL_LOSS = 1e-5
RTOL, ATOL = 1e-4, 1e-5   # a norm
TOL = 1e-4                # x max |logit|
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")


@pytest.fixture(scope="module", autouse=True)
def exact_jax_paths():
    old = (jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA)
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = "exact", "off"
    yield
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = old


# -- losses ------------------------------------------------------------------------


def seg_inputs(seed, b=2, n=300, c=6, tail=70, ties=False):
    """Logits (B, N, C) and labels with ~10% ignored and a padded tail of
    the second sample at -1; with ``ties`` every logit is 0 or 1, so that
    many errors of a class are equal."""
    rng = np.random.RandomState(seed)
    pred = rng.standard_normal((b, n, c)).astype(np.float32) * 2
    if ties:
        pred = rng.randint(0, 2, (b, n, c)).astype(np.float32)
    target = rng.randint(0, c, (b, n)).astype(np.int64)
    target[rng.rand(b, n) < 0.1] = -1
    target[1, n - tail:] = -1
    pred[1, n - tail:] = 0.0
    return pred, target


LOSS_CASES = {
    "smooth-ce": (dict(type="SmoothCELoss", smoothing_ratio=0.1), {}),
    "focal-mean": (dict(type="FocalLoss", gamma=2.0, alpha=0.25), {}),
    "focal-sum-alpha-list": (dict(type="FocalLoss", gamma=1.5, reduction="sum",
                                  alpha=[0.1, 0.2, 0.3, 0.4, 0.5, 0.6],
                                  loss_weight=0.5), {}),
    "dice": (dict(type="DiceLoss", smooth=1, exponent=2, loss_weight=2.0), {}),
    "lovasz": (dict(type="LovaszLoss", mode="multiclass", ignore_index=-1), {}),
    "lovasz-ties": (dict(type="LovaszLoss", mode="multiclass"), dict(ties=True)),
    "lovasz-class-seen": (dict(type="LovaszLoss", class_seen=4, loss_weight=0.7),
                          dict(ties=True)),
    "lovasz-absent-class": (dict(type="LovaszLoss"), dict(c=9)),
}


def assert_loss_and_grad(cfg, pred, target):
    """The port's value and autograd gradient against the JAX value and
    ``jax.grad``; returns the value."""
    jloss = JAX_LOSSES.build(dict(cfg))
    ref, ref_g = jax.value_and_grad(lambda p: jloss(p, jnp.asarray(target)))(
        jnp.asarray(pred))
    x = torch.from_numpy(pred).requires_grad_(True)
    got = LOSSES.build(dict(cfg))(x, torch.from_numpy(target))
    got.backward()
    got = float(got.detach())
    assert got == pytest.approx(float(ref), rel=RTOL_LOSS)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(x.grad.numpy(), ref_g, rtol=RTOL_LOSS,
                               atol=1e-4 * np.abs(ref_g).max())
    return got, x.grad.numpy()


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_and_gradient_match_jax(name):
    """Value and gradient; ignored and padded points have a gradient of
    exactly 0 on both sides (Lovasz: the classes of ``class_seen`` alone)."""
    cfg, kwargs = LOSS_CASES[name]
    pred, target = seg_inputs(len(name), **kwargs)
    value, grad = assert_loss_and_grad(cfg, pred, target)
    assert np.isfinite(value) and value > 0
    ignored = target == -1
    assert ignored.sum() > 70 and (grad[ignored] == 0).all()
    assert np.abs(grad[~ignored]).max() > 0


def test_lovasz_ties_are_ordered_as_in_jax():
    """With forced ties most errors of a class are shared by many points:
    the value is the same under any order of ties, the gradient only under
    the same (stable) one.  Ignored points all have error 0 and sort after
    every valid point; the gradient matches JAX's at rtol 1e-5."""
    pred, target = seg_inputs(21, ties=True)
    probs = np.asarray(jax.nn.softmax(pred.reshape(-1, 6), axis=1))
    fg = target.reshape(-1)[:, None] == np.arange(6)
    errors = np.abs(fg - probs)[target.reshape(-1) >= 0]
    assert len(np.unique(errors)) < errors.size / 20
    assert_loss_and_grad(dict(type="LovaszLoss"), pred, target)


@pytest.mark.parametrize("logits", [True, False])
def test_binary_focal_loss_matches_jax(logits):
    """Logits or probabilities, soft targets in [0, 1]; value and gradient."""
    rng = np.random.RandomState(5)
    pred = rng.standard_normal((2, 150)).astype(np.float32) * 3
    if not logits:
        pred = (0.02 + 0.96 * rng.rand(2, 150)).astype(np.float32)
    target = rng.rand(2, 150).astype(np.float32)
    target[0, :40] = np.round(target[0, :40])
    assert_loss_and_grad(dict(type="BinaryFocalLoss", gamma=2.0, alpha=0.3,
                              logits=logits, loss_weight=1.5), pred, target)


def test_lovasz_and_focal_under_autocast_run_in_f32():
    """bfloat16 logits under autocast: Lovasz and the focal loss cast to f32
    as the JAX functions do, so the value is that of the f32 logits cast
    back from bfloat16."""
    pred, target = seg_inputs(8)
    pred16 = torch.from_numpy(pred).bfloat16()
    for cfg in (dict(type="LovaszLoss"), dict(type="FocalLoss")):
        loss = LOSSES.build(cfg)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            got = loss(pred16, torch.from_numpy(target))
        assert got.dtype == torch.float32
        want = loss(pred16.float(), torch.from_numpy(target))
        assert float(got) == float(want)


# -- prompt-driven norms ------------------------------------------------------------------


def norm_inputs(seed, b=2, n=120, c=16, ctx=8):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((b, n, c)) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    context = rng.standard_normal((1, ctx)).astype(np.float32)
    return x, mask, context


def randomise_pd(tree, rng):
    """Random banks (scale, bias, running statistics) and a non-zero
    modulation, in place."""
    randomise_bn(tree, rng)
    for coll, node in tree.items():
        for path in list(flatten_tree(node)):
            leaf = path.rsplit("/", 1)[-1]
            if coll == "params" and (leaf in ("bias", "kernel")):
                parent = node
                for part in path.split("/")[:-1]:
                    parent = parent[part]
                parent[leaf] = (0.3 * rng.standard_normal(parent[leaf].shape)
                                ).astype(np.float32)
    return tree


PD_CASES = [("decoupled", True, False), ("shared", False, False),
            ("decoupled-adaptive", True, True), ("shared-adaptive", False, True)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,decouple,adaptive", PD_CASES)
def test_pd_masked_batch_norm_matches_jax(name, decouple, adaptive, train):
    """Output rtol 1e-4 / atol 1e-5 for the bank of ``S3DIS``, loaded
    through the bridge at a PT-v2 BatchNorm's place; in training every
    running statistic within 1e-6 of JAX's, the active bank moved and every
    other bank bit-equal to its start (only the active bank's statistics
    move), at the factory's momentum 0.01 and epsilon 1e-3."""
    x, mask, context = norm_inputs(len(name) + train)
    kwargs = dict(conditions=CONDITIONS, condition="S3DIS", decouple=decouple,
                  adaptive=adaptive, context_channels=8)
    jbn = jnorm.PDMaskedBatchNorm(16, momentum=0.01, epsilon=1e-3, **kwargs)
    v = randomise_pd(jinit(jbn, x, mask, train=True, context=context),
                     np.random.RandomState(3))
    norm = pnorm._bn_factory(CONDITIONS, "S3DIS", decouple, adaptive,
                             context_channels=8)(16)
    bank = norm.bns[0] if decouple else norm.bn
    assert (bank.eps, bank.momentum) == (1e-3, 0.01)
    load_from_jax(norm, v, "backbone_module/patch_bn", "backbone.patch_embed.proj.1.")
    norm.context = torch.from_numpy(context)
    start = {k: t.clone() for k, t in norm.state_dict().items()}
    norm.train(train)
    got = norm(*tt(x, mask))
    if not train:
        ref = japply(jbn, v, x, mask, train=False, context=context)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        return
    ref, mut = japply(jbn, v, x, mask, train=True, context=context,
                      mutable=["batch_stats"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)
    stats = state_dict_to_jax({"backbone.patch_embed.proj.1." + k: t
                               for k, t in norm.state_dict().items()})["batch_stats"]
    stats = stats["backbone_module"]["patch_bn"]
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(stats[leaf], np.asarray(mut["batch_stats"][leaf]),
                                   rtol=0, atol=1e-6)
    active = "bns.1." if decouple else "bn."
    for key, t in norm.state_dict().items():
        if "running" in key:
            moved = not torch.equal(t, start[key])
            assert moved == key.startswith(active), key


@pytest.mark.parametrize("name,decouple,adaptive", PD_CASES)
def test_pd_layer_norm_matches_jax(name, decouple, adaptive):
    """Each condition's bank, rtol 1e-4 / atol 1e-5; the banks and the
    modulation loaded by hand (``norm.{i}``, ``modulation.1``)."""
    x, mask, context = norm_inputs(10 + len(name))
    kwargs = dict(conditions=CONDITIONS, decouple=decouple, adaptive=adaptive,
                  context_channels=8)
    v = randomise_pd(jinit(jnorm.PDLayerNorm(16, condition="ScanNet", **kwargs),
                           x, mask, train=True, context=context),
                     np.random.RandomState(4))
    p = v["params"]
    norm = pnorm.PDLayerNorm(16, **kwargs)
    banks = norm.norm if decouple else [norm.norm]
    with torch.no_grad():
        for i, ln in enumerate(banks):
            ln.weight.copy_(torch.from_numpy(p["scale"][i]))
            ln.bias.copy_(torch.from_numpy(p["bias"][i]))
        if adaptive:
            norm.modulation[1].weight.copy_(torch.from_numpy(p["modulation"]["kernel"].T))
            norm.modulation[1].bias.copy_(torch.from_numpy(p["modulation"]["bias"]))
    norm.context = torch.from_numpy(context)
    outs = []
    for condition in CONDITIONS:
        ref = japply(jnorm.PDLayerNorm(16, condition=condition, **kwargs), v, x,
                     mask, train=True, context=context)
        norm.condition = condition
        got = norm(*tt(x, mask)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)
        outs.append(got)
    assert decouple == (np.abs(outs[0] - outs[1]).max() > 1e-3)


def test_pd_norm_refuses_an_unknown_condition_and_a_missing_context():
    norm = pnorm.PDMaskedBatchNorm(4, CONDITIONS, adaptive=True, context_channels=2)
    x = torch.ones(3, 4)
    with pytest.raises(ValueError, match="condition"):
        norm(x)
    norm.condition = "S3DIS"
    with pytest.raises(ValueError, match="context"):
        norm(x)


# -- CAC-v1m1 -------------------------------------------------------------------------------


BACKBONE = dict(
    type="PT-v2m2", in_channels=6, num_classes=0, patch_embed_depth=1,
    patch_embed_channels=16, patch_embed_groups=2, patch_embed_neighbours=8,
    enc_depths=(1, 1), enc_channels=(16, 32), enc_groups=(2, 4),
    enc_neighbours=(8, 8), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_groups=(2, 2), dec_neighbours=(8, 8), grid_sizes=(0.15, 0.3),
    drop_path_rate=0.0)
CAC = dict(type="CAC-v1m1", num_classes=5, backbone_out_channels=16,
           cos_temp=15, detach_pre_logits=True, backbone=BACKBONE,
           criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
                     dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0,
                          ignore_index=-1)])
CAC_LOSSES = ("loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss")


def seg_batch(seed, num_classes=5, absent=None):
    """``test_torch_ptv2.cloud(40)`` (2 x 2,048 points, a padded tail of
    405; its kNN tables tie-free, as ``port_run`` asserts) with labels from
    ``seed``: ~5% ignored, the padded tail at -1, class ``absent`` not in
    the batch."""
    coord, feat, mask = cloud(40)
    rng = np.random.RandomState(seed)
    segment = rng.randint(0, num_classes, mask.shape).astype(np.int64)
    segment[rng.rand(*mask.shape) < 0.05] = -1
    if absent is not None:
        segment[segment == absent] = (absent + 1) % num_classes
    segment[~mask] = -1
    return dict(coord=coord, feat=feat, mask=mask, segment=segment)


def cac_batch(seed):
    # class 4 absent: its learned prototype stays in the adaptive branch
    return seg_batch(seed, absent=4)


def float64_gradients(model, batch, loss_of, to_jax=state_dict_to_jax):
    """The gradient of ``loss_of(model(batch), batch)`` at the model's
    present state, computed in float64 on a copy, as a tree in the JAX
    layout.  The port casts to f32 at its boundaries (``.float()``); for
    this one pass a float64 tensor goes through those casts as it is."""
    to_float = torch.Tensor.float
    model = copy.deepcopy(model).double().train()
    batch = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             for k, v in batch.items()}
    batch = {k: v.double() if torch.is_tensor(v) and v.is_floating_point() else v
             for k, v in batch.items()}
    torch.Tensor.float = lambda t, *args, **kwargs: (
        t if t.dtype == torch.float64 else to_float(t, *args, **kwargs))
    try:
        loss_of(model(batch), batch).backward()
    finally:
        torch.Tensor.float = to_float
    return grad_tree(model, to_float, to_jax)


def grad_tree(model, cast=lambda t: t, to_jax=state_dict_to_jax):
    """A model's parameter gradients as a tree in the JAX layout (through
    ``to_jax``); a parameter with no gradient (a PDNorm bank not in use)
    holds zeros."""
    return to_jax({
        n: cast(p.grad) if p.grad is not None else torch.zeros_like(cast(p.detach()))
        for n, p in model.named_parameters()})["params"]


def gradient_errors(tree, ref_tree):
    """Each parameter's gradient error of its max |grad| in the reference
    tree (a bias at the larger of its own and its kernel's scale, as
    ``test_torch_train.assert_gradients_close`` holds it), and the error of
    the whole gradient in L2."""
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_tree))
    assert set(flat) == set(ref)
    errors, diff2, norm2 = {}, 0.0, 0.0
    for path, r in ref.items():
        scale = np.abs(r).max()
        kernel = path.rsplit("/", 1)[0] + "/kernel"
        if path.endswith("/bias") and kernel in ref:
            scale = max(scale, np.abs(ref[kernel]).max())
        errors[path] = float(np.abs(flat[path] - r).max() / max(scale, 1e-30))
        diff2 += float(((flat[path] - r).astype(np.float64) ** 2).sum())
        norm2 += float((r.astype(np.float64) ** 2).sum())
    return errors, (diff2 / norm2) ** 0.5


def assert_gradient_triple(port_grads, jax_grads, f64_grads, what):
    """The port's whole-network gradient against the JAX package's and
    both against the port's float64 gradient, at the tolerances of
    ``test_torch_train`` (``GRADIENT_TOL`` of a tensor's max,
    ``GRADIENT_TOL_WHOLE`` in L2):

    - the port against float64, every tensor and the whole;
    - the port against JAX, and JAX against float64, the whole;
    - the port against JAX, every tensor, except a tensor where the JAX
      gradient is itself more than ``GRADIENT_TOL`` off the float64 one:
      there the port is held against float64 alone (above), and must be
      the closer of the two.

    A PT-v2's f32 gradient has tensors fed by terms that nearly cancel (the
    query path through the softmax over the slots, BatchNorms of a few
    points at the deep levels): in either package one of those can sit
    0.2-1.1 of its max off float64 at one seed and within 0.1 at the next,
    the whole gradient within 0.02 (measured at this size)."""
    tol, tol_whole = GRADIENT_TOL, GRADIENT_TOL_WHOLE
    (pf, pf_whole), (jf, jf_whole), (pj, pj_whole) = (
        gradient_errors(a, b) for a, b in ((port_grads, f64_grads),
                                           (jax_grads, f64_grads),
                                           (port_grads, jax_grads)))
    for name, errors, whole in (("port-float64", pf, pf_whole),
                                ("JAX-float64", jf, jf_whole),
                                ("port-JAX", pj, pj_whole)):
        worst = max(errors, key=errors.get)
        print(f"{what} gradients {name}: worst tensor {errors[worst]:.3e} "
              f"({worst}), whole {whole:.3e}")
    assert max(pf.values()) <= tol and pf_whole <= tol_whole, (what, "port-float64")
    assert jf_whole <= tol_whole and pj_whole <= tol_whole, (what, "whole")
    for path, err in pj.items():
        if jf[path] > tol:
            assert pf[path] < jf[path], (what, path, pf[path], jf[path])
        else:
            assert err <= tol, (what, "port-JAX", path, err)


def port_weights(cfg, seed, noise=0.02):
    """Weights made on the port's side as a JAX tree: torch init, BatchNorm
    scales and statistics randomised, then seeded noise of ``noise`` on
    every parameter (the perturbed start of
    ``test_torch_train.perturbed_start``)."""
    torch.manual_seed(seed)
    rng = np.random.RandomState(seed)
    tree = randomise_bn(state_dict_to_jax(build_model(dict(cfg)).state_dict()), rng)
    tree["params"] = jax.tree_util.tree_map(
        lambda a: a + noise * rng.standard_normal(a.shape).astype(np.float32),
        tree["params"])
    return tree


def cac_models(seed):
    """The JAX and port CAC on one set of weights (``port_weights``)."""
    tree = port_weights(CAC, seed)
    model = build_model(dict(CAC))
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    return jax_build_model(dict(CAC)), model, tree


def port_run(model, batch):
    """The port's forward on ``batch``, asserting that no kNN of the run
    has a near-tie (the JAX kNN's matmul-identity distances could order
    it otherwise)."""
    port_knn, gaps = port.knn, []

    def recording_knn(query, ref_pts, k, ref_mask=None):
        gaps.append(knn_tie_gap(query, ref_pts, k, ref_mask))
        return port_knn(query, ref_pts, k, ref_mask)

    port.knn = recording_knn
    try:
        out = model({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    finally:
        port.knn = port_knn
    assert len(gaps) == 3 and min(gaps) >= 5e-7, gaps
    return out


def test_cac_eval_logits_match_jax():
    """Eval: the refined cosine logits within 1e-4 x max |logit| (they are
    cos_temp times a cosine, so max |logit| <= 15), 0 at padded points."""
    jmodel, model, tree = cac_models(30)
    batch = cac_batch(31)
    jbatch = {k: v for k, v in batch.items() if k != "segment"}
    ref = np.asarray(japply(jmodel, tree, jbatch, train=False)["seg_logits"])
    with torch.inference_mode():
        out = port_run(model.eval(), jbatch)
    assert set(out) == {"seg_logits"}
    got = out["seg_logits"].numpy()
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    assert 0.1 < np.abs(ref).max() <= 15.0 and (got[~batch["mask"]] == 0).all()


def test_cac_train_losses_and_gradient_match_jax():
    """Training (batch statistics, drop path 0): the five loss entries at
    rtol 1e-4; the gradient of ``loss`` in every parameter, the backbone's
    included, port against JAX and each against the port's float64
    gradient as ``assert_gradient_triple`` holds them (measured, worst
    tensor / whole: port-float64 8.7e-2 / 1.1e-2, JAX-float64 2.0e-1 /
    1.7e-2, port-JAX 2.0e-1 / 1.3e-2); the
    running statistics of the feature projection's BatchNorm (updated twice
    a forward, by both branches) within rtol 1e-5 / atol 1e-5 of JAX's."""
    jmodel, model, tree = cac_models(32)
    batch = cac_batch(36)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                                jbatch, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return out["loss"], (out, mut)

    (_, (ref, mut)), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        tree["params"])
    truth = float64_gradients(model, batch, lambda out, _: out["loss"])
    out = port_run(model.train(), batch)
    for key in CAC_LOSSES:
        assert out[key].dim() == 0
        assert float(out[key]) == pytest.approx(float(ref[key]), rel=1e-4), key
    assert float(out["kl_loss"]) > 0
    out["loss"].backward()
    assert_gradient_triple(grad_tree(model), ref_g, truth, "CAC")
    stats = state_dict_to_jax(model.state_dict())["batch_stats"]["feat_bn"]
    for leaf in ("mean", "var"):
        np.testing.assert_allclose(stats[leaf], np.asarray(mut["batch_stats"]["feat_bn"][leaf]),
                                   rtol=1e-5, atol=1e-5)


def test_cac_bridge_round_trip_bit_equal():
    """The CAC tree has the JAX model's names and shapes (``proto``,
    ``seg_bias``, ``proj1/2``, ``apd_proj1/2``, ``feat_fc1`` / ``feat_bn`` /
    ``feat_fc2``, the backbone under ``backbone_module``); JAX tree ->
    state_dict -> JAX tree is bit-equal and loads with strict=True."""
    jmodel, model, tree = cac_models(34)
    batch = {k: jnp.asarray(v) for k, v in cac_batch(35).items()}
    # initialised in training (as the JAX trainer does): the adaptive
    # branch's apd_proj has no parameters otherwise
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        batch, train=True))
    for coll in ("params", "batch_stats"):
        want = {k: tuple(s.shape) for k, s in flatten_tree(dict(shapes[coll])).items()}
        assert {k: a.shape for k, a in flatten_tree(tree[coll]).items()} == want
    sd = jax_to_state_dict(tree)
    assert sd["seg_head.weight"].shape == (5, 16) and sd["proj.0.weight"].shape == (32, 32)
    assert sd["feat_proj_layer.1.running_var"].shape == (16,)
    model.load_state_dict(sd, strict=True)
    back = state_dict_to_jax(model.state_dict())
    for coll in ("params", "batch_stats"):
        a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
