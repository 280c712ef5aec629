"""The port's Stratified Transformer slice against the JAX package on the
CPU: ``ball_query``, window ids, the cRPE window attention (bins and
output), the KPConv blocks, down/upsampling, the stratified key sets, the
whole ST-v1m1 forward in eval and in training mode, gradients of a block,
the ST recognizer with ``PointPdfV1.score``, ST-v1m2 and the weight bridge.

Inputs come from a numpy seed; parameters are made on the JAX side
(BatchNorm / LayerNorm scales and running statistics randomised) and carried
over by the bridge.  The JAX side runs its exact CPU paths in f32: exact
kNN, unfused attention and KPConv (``FUSED_ST_ATTENTION`` / ``FUSED_KPCONV``
off), which is what the port is held to; one case runs the Pallas kernel in
interpret mode, at that kernel's own loose tolerance.  Coordinates are
seeded uniform draws (off any grid), and the bins and window ids are
asserted equal, element for element.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.stratified_transformer import st as stm
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.ops.sampling import (
    blocked_farthest_point_sampling as jax_blocked_fps)
from pointcloudpdf_tpu.recognizers import build_recognizer as jax_build_recognizer
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.stratified_transformer import st as port
from pointcloudpdf_tpu_torch.ops import geometry
from pointcloudpdf_tpu_torch.ops.sampling import blocked_farthest_point_sampling
from pointcloudpdf_tpu_torch.ops.st_attention import st_attention_bins
from pointcloudpdf_tpu_torch.recognizers import build_recognizer
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_layer import randomise_bn

torch.set_num_threads(1)

CHANNELS = [16, 32, 32, 64]
BACKBONE = dict(
    type="ST-v1m1", downsample_scale=8, depths=[1, 2, 2, 1], channels=CHANNELS,
    num_heads=[1, 2, 2, 4], window_size=[0.16, 0.32, 0.64, 1.28], up_k=3,
    grid_sizes=[0.04, 0.08, 0.16, 0.32], quant_sizes=[0.01, 0.02, 0.04, 0.08],
    rel_query=True, rel_key=True, rel_value=True, drop_path_rate=0.0,
    num_layers=4, concat_xyz=True, num_classes=13, ratio=0.25, k=16,
    prev_grid_size=0.04, sigma=1.0, stem_transformer=False,
    kp_ball_radius=0.04 * 2.5, kp_max_neighbor=34, k_local=8, k_sparse=4)
MODEL = dict(type="DefaultSegmentor", backbone=BACKBONE,
             criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0,
                            ignore_index=-1)])
RECOGNIZER = dict(type="PointPdf-v1m1",
                  recognizer=dict(type="ST-v1m1-Recognizer", up_k=3,
                                  channels=CHANNELS, num_layers=4),
                  criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0,
                                 ignore_index=-1)],
                  loss_weight=0.01, step_loss_weight=False, num_classes=13,
                  start_epoch=61, kp_ball_radius=0.1, kp_max_neighbor=34)
INTERMEDIATES = ["stem", "enc1", "enc2", "enc3", "dec3", "dec2", "dec0",
                 "up0", "up1", "up2"]
TOL = 1e-4   # x max |logit|: f32 throughout, other sum orders
RTOL, ATOL = 1e-4, 1e-5   # single modules


@pytest.fixture(scope="module", autouse=True)
def exact_jax_paths():
    old = (jgeo.FORCE_KNN_PATH, stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV)
    jgeo.FORCE_KNN_PATH = "exact"
    stm.FUSED_ST_ATTENTION = stm.FUSED_KPCONV = "off"
    yield
    jgeo.FORCE_KNN_PATH, stm.FUSED_ST_ATTENTION, stm.FUSED_KPCONV = old


def cloud(seed, b=2, n=2048, extent=(1.6, 1.2, 0.8), tail=405, c=6):
    """A padded batch: uniform coords in a box, the second sample with a
    masked tail of zeros."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(b, n, 3) * np.array(extent)).astype(np.float32)
    feat = rng.rand(b, n, c).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n] + [n - tail] * (b - 1))[:, None]
    coord[~mask] = 0.0
    feat[~mask] = 0.0
    return coord, feat, mask


def knn_tie_gap(query, ref, k, ref_mask=None, ordered=False):
    """The smallest gap in d^2 (float64, direct differences) between the
    k-th and the (k+1)-th nearest valid ref, over all queries; with
    ``ordered`` between any two consecutive ones of the k + 1 nearest.  The
    JAX kNN forms d^2 by the matmul identity in f32, so below some 1e-7 of
    absolute gap it may pick, or order, the neighbours the other way."""
    q, r = np.asarray(query, np.float64), np.asarray(ref, np.float64)
    d = ((q[:, :, None] - r[:, None]) ** 2).sum(-1)
    if ref_mask is not None:
        d = np.where(np.asarray(ref_mask)[:, None, :], d, np.inf)
    d = np.sort(d, axis=-1)[..., :k + 1]
    with np.errstate(invalid="ignore"):
        gaps = np.diff(d, axis=-1)
    if not ordered:
        gaps = gaps[..., k - 1:]
    gaps = gaps[np.isfinite(gaps)]
    return float(gaps.min()) if gaps.size else float("inf")


def tt(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def jinit(module, *args, seed=0, **kwargs):
    v = jax.jit(functools.partial(module.init, **kwargs))(
        {"params": jax.random.PRNGKey(seed)}, *args)
    return jax.tree_util.tree_map(np.array, dict(v))


def japply(module, v, *args, **kwargs):
    return jax.jit(functools.partial(module.apply, **kwargs))(v, *args)


def nest(path, tree):
    for name in reversed(path.split("/")):
        tree = {name: tree}
    return tree


def load_from_jax(module, variables, jax_path, torch_prefix):
    """Carry a single JAX module's variables onto the port's module through
    the bridge, as the subtree ``jax_path`` of a segmentor."""
    sd = jax_to_state_dict({coll: nest(jax_path, variables.get(coll, {}))
                            for coll in ("params", "batch_stats")})
    assert all(k.startswith(torch_prefix) for k in sd)
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()},
                           strict=True)
    return module


def grads_as_jax(module, torch_prefix, jax_path):
    """The port module's parameter gradients as the JAX module's tree."""
    tree = state_dict_to_jax({torch_prefix + n: p.grad
                              for n, p in module.named_parameters()})
    for name in jax_path.split("/"):
        tree = {coll: sub[name] for coll, sub in tree.items() if name in sub}
    return tree["params"]


def assert_grads_close(got, ref, tol):
    """Every tensor within ``tol`` of its max |value| in ``ref``."""
    got, ref = flatten_tree(got), flatten_tree(jax.tree_util.tree_map(np.asarray, ref))
    assert set(got) == set(ref)
    for path, r in ref.items():
        err = np.abs(got[path] - r).max()
        assert err <= tol * max(np.abs(r).max(), 1e-30), (path, err)


# -- geometry -------------------------------------------------------------------


@pytest.mark.parametrize("radius,k", [(0.1, 34), (0.06, 8)])
def test_ball_query_matches_jax(radius, k):
    """Mask equal; idx equal where valid and, where not, the first index."""
    coord, _, mask = cloud(1)
    ref_idx, ref_mask = jax.jit(jax.vmap(
        lambda c, m: jgeo.ball_query(c, c, radius, k, ref_mask=m)))(coord, mask)
    idx, nmask = geometry.ball_query(*tt(coord, coord), radius, k,
                                     ref_mask=tt(mask)[0])
    ref_idx, ref_mask = np.asarray(ref_idx), np.asarray(ref_mask)
    np.testing.assert_array_equal(nmask.numpy(), ref_mask)
    assert 0.02 < ref_mask.mean() < 0.9
    np.testing.assert_array_equal(idx.numpy()[ref_mask], ref_idx[ref_mask])
    np.testing.assert_array_equal(idx.numpy()[:, :, 0], ref_idx[:, :, 0])
    first = np.broadcast_to(idx.numpy()[:, :, :1], idx.shape)
    np.testing.assert_array_equal(idx.numpy()[~ref_mask], first[~ref_mask])


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("window", [0.16, 0.64])
def test_window_ids_match_jax(window, shift):
    """Equal at every point (a division by the window size on both sides)."""
    coord, _, mask = cloud(2)
    ref = jax.jit(functools.partial(stm._window_ids, window_size=window,
                                    shift=shift))(coord, mask)
    got = port._window_ids(*tt(coord, mask), window, shift)
    differing = int((got.numpy() != np.asarray(ref).astype(np.int64)).sum())
    assert differing == 0
    assert len(np.unique(got.numpy()[mask])) > 8


# -- attention ------------------------------------------------------------------


def attention_inputs(seed, b=2, n=160, k=12, c=32):
    rng = np.random.RandomState(seed)
    coord = (rng.rand(b, n, 3) * 0.5).astype(np.float32)
    feat = (rng.rand(b, n, c) - 0.5).astype(np.float32)
    mask = rng.rand(b, n) > 0.1
    key_idx = rng.randint(0, n, (b, n, k)).astype(np.int32)
    key_mask = rng.rand(b, n, k) > 0.2
    key_mask[:, 3] = False               # a query with no key
    return feat, coord, key_idx, key_mask, mask


@jax.jit
def jax_bins(coord, key_idx, two_l, window_size, quant_size):
    """The bin expression of the JAX attention (st.py), on its own."""
    pos_g = jax.vmap(lambda f, i: f[i])(coord, key_idx)
    rel = coord[:, :, None, :] - pos_g
    bins = jnp.floor((rel + 2 * window_size - 1e-4) / quant_size).astype(jnp.int32)
    return jnp.clip(bins, 0, two_l - 1)


def build_attention(rel, window=0.16, quant=0.01):
    kwargs = dict(dim=32, num_heads=2, window_size=window, quant_size=quant,
                  rel_query=rel[0], rel_key=rel[1], rel_value=rel[2])
    return (stm.StratifiedWindowAttention(**kwargs),
            port.StratifiedWindowAttention(**kwargs).eval())


@pytest.mark.parametrize("rel", [(True, True, True), (False, False, False),
                                 (True, False, False), (False, True, False),
                                 (False, False, True)])
def test_window_attention_matches_jax(rel):
    """Each cRPE table on and off: bins equal at every (query, key, axis);
    output rtol 1e-4 / atol 1e-5 against the unfused JAX path."""
    args = attention_inputs(3)
    jattn, attn = build_attention(rel)
    v = jinit(jattn, *args, train=False)
    for name in v["params"]:   # zero-centred tables would hide a wrong row
        if name.endswith("_table"):
            v["params"][name] = (np.random.RandomState(4).standard_normal(
                v["params"][name].shape) * 0.3).astype(np.float32)
    ref = np.asarray(japply(jattn, v, *args, train=False))
    load_from_jax(attn, v, "backbone_module/layer1_block0/attn",
                  "backbone.layers.0.blocks.0.attn.")
    with torch.inference_mode():
        got = attn(*tt(*args)).numpy()
    _, coord, key_idx, _, _ = args
    bins = st_attention_bins(*tt(coord, key_idx), 0.16, 0.01, attn.num_bins)
    ref_bins = np.asarray(jax_bins(coord, key_idx, attn.num_bins, 0.16, 0.01))
    assert attn.num_bins == 64 and int((bins.numpy() != ref_bins).sum()) == 0
    assert len(np.unique(ref_bins)) > 20
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(got[:, 3]).max() == 0.0


def test_window_attention_close_to_pallas_interpret():
    """Against the fused TPU kernel in interpret mode (bf16 payloads, dots
    rounded to bf16): 2e-2 of the maximum, the tolerance of
    tests/test_pallas_st_attention.py."""
    args = attention_inputs(5, n=96)
    jattn, attn = build_attention((True, True, True), window=0.2)
    v = jinit(jattn, *args, train=False)
    stm.FUSED_ST_ATTENTION = "interpret"
    try:
        ref = np.asarray(japply(jattn, v, *args, train=False))
    finally:
        stm.FUSED_ST_ATTENTION = "off"
    load_from_jax(attn, v, "backbone_module/layer1_block0/attn",
                  "backbone.layers.0.blocks.0.attn.")
    with torch.inference_mode():
        got = attn(*tt(*args)).numpy()
    assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6) < 2e-2


def test_drop_path_draws_whole_samples_from_the_generator():
    """Training mode: a sample's branch is kept (scaled by 1 / keep) or
    dropped as a whole, the draws come from the generator handed in (the same
    seed gives the same draws), and eval mode drops nothing."""
    block = port.STBlock(32, 2, 0.16, 0.01, True, True, True, drop_path=0.4)
    x = torch.ones(64, 5, 32)
    gen = torch.Generator().manual_seed(1)
    first = block.train()._drop_path(x, gen)
    again = block._drop_path(x, gen.manual_seed(1))
    assert torch.equal(first, again)
    per_sample = first.flatten(1)
    assert (per_sample == per_sample[:, :1]).all()
    kept = per_sample[:, 0] != 0
    assert 20 < int(kept.sum()) < 56
    torch.testing.assert_close(per_sample[kept, 0], torch.full((int(kept.sum()),), 1 / 0.6))
    assert block.eval()._drop_path(x, gen) is x


# -- KPConv, down / up ------------------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
def test_kpconv_block_matches_jax(residual):
    """Plain (6 -> 16) and residual (16 -> 16) blocks, eval: rtol 1e-4 /
    atol 1e-5 (measured 1.7e-6 and 3.0e-7 in outputs of ~1.8: direct
    differences against the JAX path's matmul-identity distances)."""
    c_in = 16 if residual else 6
    coord, feat, mask = cloud(6, n=1024, tail=200, c=c_in)
    kwargs = dict(in_channels=c_in, out_channels=16, prev_grid_size=0.04,
                  sigma=1.0, residual=residual, kp_radius=2.5, max_neighbor=34)
    jblock, block = stm.KPConvBlock(**kwargs), port.KPConvBlock(**kwargs).eval()
    v = randomise_bn(jinit(jblock, feat, coord, mask, train=False),
                     np.random.RandomState(7))
    v["params"]["kp_weight"] = v["params"]["kp_weight"] * 10
    ref = np.asarray(japply(jblock, v, feat, coord, mask, train=False))
    stem = "stem1" if residual else "stem0"
    load_from_jax(block, v, f"backbone_module/{stem}",
                  f"backbone.stem_layer.{int(residual)}.")
    np.testing.assert_array_equal(block.kpconv.K_points.numpy(),
                                  v["batch_stats"]["kp_points"])
    with torch.inference_mode():
        got = block(*tt(feat, coord, mask)).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("exact_count,group_steps,m", [(False, 128, 256),
                                                       (True, 1 << 20, 257)])
def test_transition_down_matches_jax(exact_count, group_steps, m):
    """Tile-aligned counts with morton-blocked FPS, and the reference's exact
    count with sequential FPS: same picks and valid flags; features rtol
    1e-4 / atol 1e-5."""
    coord, feat, mask = cloud(8, n=1024, tail=300, c=16)
    kwargs = dict(in_channels=16, out_channels=32, ratio=0.25, k=16,
                  exact_count=exact_count, fps_group_steps=group_steps)
    jdown, down = stm.TransitionDown(**kwargs), port.TransitionDown(**kwargs).eval()
    v = randomise_bn(jinit(jdown, feat, coord, mask, train=False),
                     np.random.RandomState(9))
    ref_feat, ref_coord, ref_valid = japply(jdown, v, feat, coord, mask, train=False)
    load_from_jax(down, v, "backbone_module/stem_down", "backbone.downsample.")
    with torch.inference_mode():
        got = down(port.Points(*tt(coord, feat, mask)))
    assert got.coord.shape == (2, m, 3)
    np.testing.assert_array_equal(got.coord.numpy(), np.asarray(ref_coord))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(got.feat.numpy(), np.asarray(ref_feat),
                               rtol=RTOL, atol=ATOL)


def test_upsample_matches_jax():
    """rtol 1e-4 / atol 3e-4 (measured 1.2e-4).  The inverse-distance weights
    amplify the JAX kNN's distances, which come from the matmul identity
    |q|^2 + |r|^2 - 2 q.r and carry ~1e-6 of absolute noise in d^2 (1e-4 of a
    d^2 of 0.01 here); the port's are direct differences."""
    coord, feat, mask = cloud(10, n=256, tail=60, c=32)
    s_coord, s_feat, s_mask = cloud(11, n=1024, tail=200, c=16)
    jup, up = stm.Upsample(3, 32, 16), port.Upsample(3, 32, 16).eval()
    args = (feat, coord, mask, s_feat, s_coord, s_mask)
    v = randomise_bn(jinit(jup, *args, train=False), np.random.RandomState(12))
    ref = np.asarray(japply(jup, v, *args, train=False))
    load_from_jax(up, v, "up0", "upsamples.0.")
    with torch.inference_mode():
        got = up(port.Points(*tt(coord, feat, mask)),
                 port.Points(*tt(s_coord, s_feat, s_mask))).feat.numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=3e-4)


def test_key_sets_of_a_two_parity_layer_match_jax():
    """Both shift parities: key rows equal where the mask is set, masks
    equal, local and sparse keys both present.  The cloud must have no
    near-tie among the neighbours of either kNN, which is asserted: on seed
    13 two neighbours of one query lie at d^2 = 0.02701062 and 0.02701064
    (a gap of 1.7e-8), and the JAX kNN, whose distances come from the
    matmul identity, lists them in the wrong order."""
    coord, _, mask = cloud(17, n=1024, tail=200)
    m = 1024 // 8
    assert knn_tie_gap(coord, coord, 8, mask, ordered=True) >= 5e-7
    ds_idx, ds_valid = jax.jit(jax.vmap(
        lambda c, mk: jax_blocked_fps(c, m, mask=mk, max_group_steps=128)))(coord, mask)
    pidx, pvalid = blocked_farthest_point_sampling(
        *tt(coord), m, tt(mask)[0], max_group_steps=128)
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(ds_idx))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(ds_valid))
    ds_coord = np.take_along_axis(coord, pidx.numpy()[..., None].astype(np.int64), 1)
    assert knn_tie_gap(coord, ds_coord, 4, pvalid.numpy(), ordered=True) >= 5e-7
    jbackbone = jax_build_model(BACKBONE)
    ref = jax.jit(functools.partial(
        jbackbone._key_sets_layer, window_size=0.32, depth=2, k_local=8,
        k_sparse=4))(coord, mask, ds_idx=ds_idx, ds_valid=ds_valid)
    got = port.key_sets_layer(*tt(coord, mask), 0.32, 2, pidx, pvalid, 8, 4)
    assert len(got) == len(ref) == 2
    for (idx, kmask), (ref_idx, ref_mask) in zip(got, ref):
        ref_idx, ref_mask = np.asarray(ref_idx), np.asarray(ref_mask)
        assert idx.dtype == torch.int32 and idx.shape == (2, 1024, 12)
        np.testing.assert_array_equal(kmask.numpy(), ref_mask)
        np.testing.assert_array_equal(idx.numpy()[ref_mask], ref_idx[ref_mask])
        assert idx.min() >= 0 and idx.max() < 1024
        assert ref_mask[..., :8].any() and ref_mask[..., 8:].any()
    assert (got[0][1] != got[1][1]).any()


# -- the whole model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def both(exact_jax_paths):
    coord, feat, mask = cloud(0)
    batch = dict(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                 mask=jnp.asarray(mask))
    rng = np.random.RandomState(14)
    jm = jax_build_model(MODEL)
    v = randomise_bn(jinit(jm, batch, train=False), rng)
    jout = japply(jm, v, batch, train=False)
    jrec = jax_build_recognizer(RECOGNIZER)
    rv = randomise_bn(jinit(jrec.model, jout["intermediates"], seed=1,
                            train=False), rng)
    jraw = japply(jrec.model, rv, jout["intermediates"], train=False)
    jscore = jrec.score(jout["seg_logits"], jraw)
    jtrain, jmut = japply(jm, v, batch, train=True, mutable=["batch_stats"])

    tbatch = dict(zip(("coord", "feat", "mask"), tt(coord, feat, mask)))
    model = build_model(MODEL).eval()
    model.load_state_dict(jax_to_state_dict(v), strict=True)
    rec = build_recognizer(RECOGNIZER)
    rec.model.eval().load_state_dict(jax_to_state_dict(rv), strict=True)
    with torch.inference_mode():
        tout = model(tbatch)
        traw = rec.model(tout["intermediates"])
        tscore = rec.score(tout["seg_logits"], traw)
    model.train()
    ttrain = model(tbatch)
    tstats = state_dict_to_jax(model.state_dict())["batch_stats"]
    model.eval()
    return dict(
        jax=dict(out=jout, raw=np.asarray(jraw), score=np.asarray(jscore), v=v,
                 rv=rv, train=jtrain, stats=jmut["batch_stats"]),
        port=dict(out=tout, raw=traw.numpy(), score=tscore.numpy(), model=model,
                  rec=rec, train=ttrain, stats=tstats),
        scale=float(np.abs(np.asarray(jout["seg_logits"])).max()))


def assert_outputs_close(got, ref, scale):
    """Logits and every intermediate within 1e-4 x max |logit|; the FPS
    picks and masks of every level equal."""
    ref_logits = np.asarray(ref["seg_logits"])
    assert ref_logits.shape == (2, 2048, 13)
    assert np.abs(got["seg_logits"].detach().numpy() - ref_logits).max() <= TOL * scale
    assert set(got["intermediates"]) == set(ref["intermediates"]) == set(INTERMEDIATES)
    for name in INTERMEDIATES:
        r_feat, r_coord, r_mask = ref["intermediates"][name]
        g = got["intermediates"][name]
        np.testing.assert_array_equal(g.coord.numpy(), np.asarray(r_coord))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(r_mask))
        err = np.abs(g.feat.detach().numpy() - np.asarray(r_feat)).max()
        assert err <= TOL * scale, (name, err)


def test_st_forward_matches_jax(both):
    assert_outputs_close(both["port"]["out"], both["jax"]["out"], both["scale"])
    assert both["port"]["out"]["intermediates"]["enc3"].feat.shape == (2, 32, 64)


def test_st_training_mode_forward_matches_jax(both):
    """Training mode (batch statistics, plain attention and KPConv cores,
    drop path 0): values as in eval; every running statistic within 1e-6 of
    the JAX package's after the one forward."""
    assert_outputs_close(both["port"]["train"], both["jax"]["train"], both["scale"])
    got = flatten_tree(both["port"]["stats"])
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, both["jax"]["stats"]))
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0, atol=1e-6, err_msg=path)


def test_st_recognizer_and_score_match_jax(both):
    """Confidence within 1e-4 x max |logit|; K+1 softmax score atol 1e-5."""
    assert both["port"]["raw"].shape == both["jax"]["raw"].shape == (2, 2048, 1)
    assert (np.abs(both["port"]["raw"] - both["jax"]["raw"]).max()
            <= TOL * both["scale"])
    np.testing.assert_allclose(both["port"]["score"], both["jax"]["score"],
                               atol=1e-5)


@pytest.mark.parametrize("which", ["model", "recognizer"])
def test_st_bridge_round_trip_bit_equal(both, which):
    """JAX tree -> state_dict -> JAX tree is bit-equal, ``kp_points`` and the
    cRPE tables included, and the module loads it with strict=True."""
    tree = both["jax"]["v" if which == "model" else "rv"]
    module = (both["port"]["model"] if which == "model"
              else both["port"]["rec"].model)
    sd = jax_to_state_dict(tree)
    module.load_state_dict(sd, strict=True)
    back = state_dict_to_jax(module.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(flat_back)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_back[path], leaf)
        assert flat_back[path].dtype == leaf.dtype
    if which == "model":
        assert sd["backbone.stem_layer.1.kpconv.K_points"].shape == (15, 3)
        assert sd["backbone.stem_layer.0.kpconv.weight"].shape == (15, 6, 16)
        assert sd["backbone.layers.1.blocks.1.attn.relative_pos_key_table"
                  ].shape == (64, 2, 16, 3)
        assert sd["backbone.upsamples.2.linear2.1.weight"].shape == (16, 32)
        assert "backbone.layers.2.downsample.linear.weight" not in sd


# -- gradients --------------------------------------------------------------------


def test_st_block_gradient_matches_jax_grad():
    """A training-mode STBlock: the gradient of a weighted sum of its output
    in every parameter and in its input, within 1e-3 of each tensor's max."""
    feat, coord, key_idx, key_mask, mask = attention_inputs(15)
    weight = np.random.RandomState(16).standard_normal(feat.shape).astype(np.float32)
    kwargs = dict(dim=32, num_heads=2, window_size=0.16, quant_size=0.01,
                  rel_query=True, rel_key=True, rel_value=True, drop_path=0.0)
    jblock, block = stm.STBlock(**kwargs), port.STBlock(**kwargs).train()
    v = jinit(jblock, feat, coord, key_idx, key_mask, mask, train=True)

    def loss(params, x):
        out = jblock.apply({"params": params}, x, coord, key_idx, key_mask,
                           mask, train=True)
        return jnp.sum(out * weight)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], feat)
    load_from_jax(block, v, "backbone_module/layer1_block0",
                  "backbone.layers.0.blocks.0.")
    x = torch.from_numpy(feat).requires_grad_(True)
    out = block(x, *tt(coord, key_idx, key_mask, mask))
    (out * torch.from_numpy(weight)).sum().backward()
    assert_grads_close(
        grads_as_jax(block, "backbone.layers.0.blocks.0.",
                     "backbone_module/layer1_block0"), ref_p, 1e-3)
    assert np.abs(x.grad.numpy() - np.asarray(ref_x)).max() <= 1e-3 * np.abs(ref_x).max()


def test_kpconv_block_gradient_matches_jax_grad():
    """A training-mode residual KPConvBlock, as above (1e-3)."""
    coord, feat, mask = cloud(17, n=512, tail=100, c=16)
    weight = np.random.RandomState(18).standard_normal((2, 512, 32)).astype(np.float32)
    kwargs = dict(in_channels=16, out_channels=32, prev_grid_size=0.04,
                  sigma=1.0, residual=True, kp_radius=2.5, max_neighbor=34)
    jblock, block = stm.KPConvBlock(**kwargs), port.KPConvBlock(**kwargs).train()
    v = jinit(jblock, feat, coord, mask, train=False)
    v["params"]["kp_weight"] = v["params"]["kp_weight"] * 10

    def loss(params, x):
        out, _ = jblock.apply({"params": params, "batch_stats": v["batch_stats"]},
                              x, coord, mask, train=True, mutable=["batch_stats"])
        return jnp.sum(out * weight)

    ref_p, ref_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"], feat)
    load_from_jax(block, v, "backbone_module/stem1", "backbone.stem_layer.1.")
    x = torch.from_numpy(feat).requires_grad_(True)
    out = block(x, *tt(coord, mask))
    (out * torch.from_numpy(weight)).sum().backward()
    assert_grads_close(grads_as_jax(block, "backbone.stem_layer.1.",
                                    "backbone_module/stem1"), ref_p, 1e-3)
    assert np.abs(x.grad.numpy() - np.asarray(ref_x)).max() <= 1e-3 * np.abs(ref_x).max()


# -- the other constructors ---------------------------------------------------------


def test_st_v1m2_builds_and_matches_jax():
    """The refined constructor maps onto the same module, here with the
    reference's exact downsample counts and sequential FPS: logits within
    1e-4 x max |logit| on a two-layer model."""
    cfg = dict(type="ST-v1m2", in_channels=6, num_classes=13,
               channels=(16, 32, 32), num_heads=(2, 2), depths=(2, 1),
               window_size=(0.2, 0.4), quant_size=(0.01, 0.02), kp_grid_size=0.04,
               kp_ball_radius=0.1, drop_path_rate=0.0, k_local=8, k_sparse=4,
               ref_exact_counts=True, fps_group_steps=1 << 20)
    coord, feat, mask = cloud(19, n=1024, tail=150)
    batch = dict(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                 mask=jnp.asarray(mask))
    jm = jax_build_model(cfg)
    v = randomise_bn(jinit(jm, batch, train=False), np.random.RandomState(20))
    ref = np.asarray(japply(jm, v, batch, train=False)[0])
    model = build_model(cfg).eval()
    assert len(model.layers) == 2 and model.layers[0].blocks[0].attn.num_heads == 2
    load_from_jax(model, v, "backbone_module", "backbone.")
    with torch.inference_mode():
        got = model(dict(zip(("coord", "feat", "mask"), tt(coord, feat, mask))))[0]
    assert np.abs(got.numpy() - ref).max() <= TOL * np.abs(ref).max()


def test_scannet_st_config_builds_at_real_widths():
    """The five-layer ScanNet config builds (no forward): widths, depths and
    table sizes as published, and the same parameter count as the JAX tree's
    shapes give."""
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs/scannet/openseg-st-v1m1-0-origin-pointpdf-v1m1-base.py")
    cfg = Config.fromfile(path)
    model = build_model(dict(cfg.model))
    rec = build_recognizer(cfg.recognizer)
    backbone = model.backbone
    depths = list(cfg.model.backbone.depths)
    channels = list(cfg.model.backbone.channels)
    assert cfg.model.backbone.num_layers == 5 and len(backbone.layers) == 4
    assert [len(layer.blocks) for layer in backbone.layers] == depths[1:]
    assert [layer.blocks[0].attn.dim for layer in backbone.layers] == channels[1:]
    assert all(layer.blocks[0].attn.dim // layer.blocks[0].attn.num_heads == 16
               for layer in backbone.layers)
    assert len(backbone.upsamples) == len(rec.model.upsamples) == 4
    tree = state_dict_to_jax(model.state_dict())
    assert "layer4_block0" in tree["params"]["backbone_module"]
    assert "up0" in tree["params"]["backbone_module"]
    jm = jax_build_model(JaxConfig.fromfile(path).model)
    batch = dict(coord=jnp.zeros((1, 1024, 3)), feat=jnp.zeros((1, 1024, 6)),
                 mask=jnp.ones((1, 1024), bool))
    shapes = jax.eval_shape(functools.partial(jm.init, train=False),
                            {"params": jax.random.PRNGKey(0)}, batch)
    for coll in ("params", "batch_stats"):
        ref = {k: tuple(s.shape) for k, s in flatten_tree(dict(shapes[coll])).items()}
        got = {k: tuple(a.shape) for k, a in flatten_tree(tree[coll]).items()}
        assert got == ref and len(ref) > 4
