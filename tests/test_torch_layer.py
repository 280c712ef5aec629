"""PointTransformerLayer of the PyTorch port against the JAX layer, on
weights carried over by the bridge (BatchNorm statistics randomised so the
folding into kernel K3's affines is exercised), in eval and in training
mode (output, running statistics, gradients).

The JAX side runs its unfused f32 path and, as a second reference, the
fused Pallas attention kernels in interpret mode with an f32 payload.  The
port runs its unfused modules and the fused route's plain version (batch
statistic affines + ``vector_attention_train``, what the card runs through
kernels K3 and K4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.models.point_transformer import modules as ptmod
from pointcloudpdf_tpu.models.utils.structure import Points as JPoints
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict
from pointcloudpdf_tpu_torch.models.norm import MaskedBatchNorm
from pointcloudpdf_tpu_torch.models.point_transformer import PointTransformerLayer
from pointcloudpdf_tpu_torch.models.utils.structure import Points, where_valid
from pointcloudpdf_tpu_torch.ops.geometry import knn
from pointcloudpdf_tpu_torch.ops.vector_attention import (
    vector_attention, vector_attention_train_plain)

torch.set_num_threads(1)

_PREFIX = "backbone.enc1.1.transformer."


def randomise_bn(tree, rng):
    """Random BatchNorm scale and running statistics, in place."""
    for coll, node in tree.items():
        def walk(d):
            for k, v in d.items():
                if isinstance(v, dict):
                    walk(v)
                elif coll == "params" and k == "scale":
                    d[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
                elif coll == "batch_stats" and k == "mean":
                    d[k] = (0.2 * rng.standard_normal(v.shape)).astype(np.float32)
                elif coll == "batch_stats" and k == "var":
                    d[k] = (0.5 + 1.5 * rng.rand(*v.shape)).astype(np.float32)
        walk(node)
    return tree


def _setup(c, k, seed=0):
    rng = np.random.RandomState(seed)
    b, n = 2, 200
    coord = rng.rand(b, n, 3).astype(np.float32)
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, n - 37])[:, None]
    jlayer = ptmod.PointTransformerLayer(c, c, share_planes=8, nsample=k)
    jpts = JPoints(jnp.asarray(coord), jnp.asarray(feat), jnp.asarray(mask))
    v = jax.jit(lambda: jlayer.init(jax.random.PRNGKey(seed), jpts, False))()
    v = randomise_bn(jax.tree_util.tree_map(np.array, dict(v)), rng)
    wrapped = {coll: {"backbone_module": {"enc1": {"block0": {"transformer": t}}}}
               for coll, t in v.items()}
    state = {key[len(_PREFIX):]: val
             for key, val in jax_to_state_dict(wrapped).items()}
    layer = PointTransformerLayer(c, c, share_planes=8, nsample=k)
    layer.load_state_dict(state, strict=True)
    pts = Points(torch.from_numpy(coord), torch.from_numpy(feat),
                 torch.from_numpy(mask))
    return jlayer, jpts, v, layer, pts


def _jax_apply(jlayer, jpts, v, mode, train=False):
    old, old_dt = ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE
    ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE = mode, "float32"
    try:
        if train:
            return jax.jit(lambda v: jlayer.apply(
                v, jpts, True, mutable=["batch_stats"]))(v)
        return jax.jit(lambda v: jlayer.apply(v, jpts, False))(v)
    finally:
        ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE = old, old_dt


@pytest.mark.parametrize("c,k", [(32, 8), (64, 16)])
def test_layer_eval_matches_jax_unfused(c, k):
    """atol 1e-5, rtol 1e-4: the same f32 math, folded BatchNorm affines
    and another summation order."""
    jlayer, jpts, v, layer, pts = _setup(c, k)
    ref = np.asarray(_jax_apply(jlayer, jpts, v, "off"))
    layer.eval()
    with torch.inference_mode():
        out = layer(pts).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    assert (out[~pts.mask.numpy()] == 0).all()


def test_layer_eval_matches_pallas_interpret():
    """Against the TPU kernel in interpret mode with an f32 payload, at the
    tolerance its own test holds it to the unfused path (rtol 1e-4,
    atol 1e-5)."""
    jlayer, jpts, v, layer, pts = _setup(32, 8, seed=1)
    ref = np.asarray(_jax_apply(jlayer, jpts, v, "interpret"))
    layer.eval()
    with torch.inference_mode():
        out = layer(pts).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_layer_train_matches_jax():
    """Train mode runs the unfused modules with masked batch statistics:
    output and the updated running statistics match the JAX layer."""
    jlayer, jpts, v, layer, pts = _setup(32, 8, seed=2)
    ref, updated = _jax_apply(jlayer, jpts, v, "off", train=True)
    layer.train()
    out = layer(pts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    bn_w1 = layer.linear_w[0]
    np.testing.assert_allclose(
        bn_w1.running_mean.numpy(),
        np.asarray(updated["batch_stats"]["bn_w1"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        bn_w1.running_var.numpy(),
        np.asarray(updated["batch_stats"]["bn_w1"]["var"]), rtol=1e-5, atol=1e-6)
    assert int(bn_w1.num_batches_tracked) == 1
    out.sum().backward()
    assert layer.linear_q.weight.grad is not None


def test_masked_batchnorm_eval_is_folded_affine():
    rng = np.random.RandomState(3)
    bn = MaskedBatchNorm(16).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(16).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.rand(16).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.rand(16).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(1 + rng.rand(16).astype(np.float32)))
    x = torch.from_numpy(rng.standard_normal((5, 7, 16)).astype(np.float32))
    scale, shift = bn.affine()
    torch.testing.assert_close(bn(x), x * scale + shift, rtol=1e-6, atol=1e-6)


def test_vector_attention_output_channel_groups():
    """Output channel c takes weight group c % G (the JAX (share, G)
    reshape): with v = one-hot channel ids and a single valid neighbour,
    the output is v itself whatever the weights."""
    rng = np.random.RandomState(4)
    b, n, c, k = 1, 6, 32, 4
    g = c // 8
    coord = torch.from_numpy(rng.rand(b, n, 3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, n, c)).astype(np.float32))
    v = torch.arange(c, dtype=torch.float32).expand(b, n, c).contiguous()
    idx = torch.zeros((b, n, k), dtype=torch.int32)
    nmask = torch.zeros((b, n, k), dtype=torch.bool)
    nmask[..., 0] = True
    zeros = [torch.zeros(s) for s in ((3, 3), (3,), (3, c), (c,), (c, g), (g,),
                                      (g, g), (g,))]
    ones = [torch.ones(3), torch.zeros(3), torch.ones(c), torch.zeros(c),
            torch.ones(g), torch.zeros(g)]
    out = vector_attention(x, x, v, coord, idx, nmask, *zeros, *ones)
    torch.testing.assert_close(out, v[:, :1].expand(b, n, c))



# -- training mode: output, running statistics, gradients --------------------


def _port_fused_forward(layer, pts):
    """The layer's training forward on the fused route (on the CPU its
    plain version), as ``forward`` takes it for a CUDA tensor."""
    coord, x, mask = pts
    idx, dist2 = knn(coord, coord, layer.nsample, ref_mask=mask)
    nmask = torch.isfinite(dist2) & mask[..., None]
    out = layer._fused_train(coord, layer.linear_q(x), layer.linear_k(x),
                             layer.linear_v(x), idx, nmask)
    return where_valid(mask, out)


def _port_train(layer, pts, wvec, fused):
    layer.train()
    feat = pts.feat.clone().requires_grad_(True)
    pts = Points(pts.coord, feat, pts.mask)
    out = _port_fused_forward(layer, pts) if fused else layer(pts)
    layer.zero_grad()
    (out * torch.from_numpy(wvec)).sum().backward()
    grads = {n: p.grad.numpy().copy() for n, p in layer.named_parameters()}
    stats = {n: b.numpy().copy() for n, b in layer.named_buffers()
             if "num_batches" not in n}
    return out.detach().numpy(), stats, grads, feat.grad.numpy()


def _jax_train(jlayer, jpts, v, wvec, mode):
    """(out, running statistics, parameter grads, feature grad) of the JAX
    layer, all under the port's names."""
    old, old_dt = ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE
    ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE = mode, "float32"
    try:
        def loss_fn(params, f):
            out, mut = jlayer.apply(
                {"params": params, "batch_stats": v["batch_stats"]},
                JPoints(jpts.coord, f, jpts.mask), True, mutable=["batch_stats"])
            return jnp.sum(out * wvec), (out, mut["batch_stats"])

        (_, (out, stats)), (gp, gf) = jax.jit(jax.value_and_grad(
            loss_fn, argnums=(0, 1), has_aux=True))(v["params"], jpts.feat)
    finally:
        ptmod.FUSED_ATTENTION, ptmod.FUSED_PAYLOAD_DTYPE = old, old_dt

    def named(params, stats):
        wrapped = {"params": {"backbone_module": {"enc1": {"block0": {
                       "transformer": jax.tree_util.tree_map(np.array, params)}}}},
                   "batch_stats": {"backbone_module": {"enc1": {"block0": {
                       "transformer": jax.tree_util.tree_map(np.array, stats)}}}}}
        return {k[len(_PREFIX):]: t.numpy()
                for k, t in jax_to_state_dict(wrapped).items()
                if "num_batches" not in k}

    zeros = jax.tree_util.tree_map(np.zeros_like, v["params"])
    stats_named = {k: a for k, a in named(zeros, stats).items()
                   if "running" in k}
    grads_named = {k: a for k, a in named(gp, {}).items()}
    return np.asarray(out), stats_named, grads_named, np.asarray(gf)


@pytest.mark.parametrize("jax_mode", ["off", "interpret"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused-plain"])
def test_layer_train_matches_jax_with_gradients(jax_mode, fused):
    """Values (output, the three BatchNorms' updated running statistics):
    rtol 1e-4, atol 1e-5.  Gradients of the input features and of every
    parameter: within 1e-3 of that tensor's max |grad|, plus 1e-5 of the
    largest parameter gradient as the floor for tensors whose exact
    gradient is 0 (a bias ahead of a batch-statistic BatchNorm, the last
    bias ahead of the softmax), where both sides hold rounding noise."""
    jlayer, jpts, v, layer, pts = _setup(32, 8, seed=5)
    wvec = np.random.RandomState(6).standard_normal(
        pts.feat.shape).astype(np.float32)
    ref_out, ref_stats, ref_grads, ref_gf = _jax_train(
        jlayer, jpts, v, wvec, jax_mode)
    out, stats, grads, gf = _port_train(layer, pts, wvec, fused)
    np.testing.assert_allclose(out, ref_out, rtol=1e-4, atol=1e-5)
    assert len(ref_stats) == 6
    for name, ref in ref_stats.items():
        np.testing.assert_allclose(stats[name], ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert set(ref_grads) == set(grads)
    floor = 1e-5 * max(np.abs(g).max() for g in ref_grads.values())
    for name, ref in ref_grads.items():
        assert np.abs(grads[name] - ref).max() <= 1e-3 * np.abs(ref).max() + floor, name
    assert np.abs(gf - ref_gf).max() <= 1e-3 * np.abs(ref_gf).max()


def test_masked_batchnorm_train_affine_matches_forward():
    """``train_affine`` on externally computed statistics gives forward's
    output and the same running-statistic update."""
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.standard_normal((3, 9, 16)).astype(np.float32))
    mask = torch.from_numpy(rng.rand(3, 9) > 0.3)
    a, b = MaskedBatchNorm(16).train(), MaskedBatchNorm(16).train()
    want = a(x, mask)
    w = mask.float()
    cnt = w.sum()
    mean = (x * w[..., None]).sum((0, 1)) / cnt
    var = (x * x * w[..., None]).sum((0, 1)) / cnt - mean * mean
    scale, shift = b.train_affine(mean, var, cnt)
    torch.testing.assert_close(x * scale + shift, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b.running_var, a.running_var)
    torch.testing.assert_close(b.running_mean, a.running_mean)
    assert int(b.num_batches_tracked) == 1


def test_vector_attention_train_plain_gradcheck():
    """Finite differences on the plain version of K4 (float64, a tiny
    case): its autograd is what the kernel's backward is held against."""
    rng = np.random.RandomState(9)
    b, n, c, k = 1, 6, 32, 3
    g = c // 8

    def t(*shape, scale=1.0, grad=True):
        return torch.from_numpy(rng.standard_normal(shape) * scale
                                ).requires_grad_(grad)

    coord = t(b, n, 3, grad=False)
    idx = torch.from_numpy(rng.randint(0, n, (b, n, k)))
    nmask = torch.from_numpy(rng.rand(b, n, k) > 0.2)
    nmask[0, 1] = False  # a query with no valid neighbour
    args = [t(b, n, c), t(b, n, c), t(b, n, c), coord, idx, nmask,
            t(3, 3), t(3), t(3, c), t(c), t(c, g, scale=0.3), t(g),
            t(g, g, scale=0.5), t(g), t(3), t(3), t(c), t(c), t(g), t(g)]
    assert torch.autograd.gradcheck(vector_attention_train_plain, args,
                                    eps=1e-6, atol=1e-5, rtol=1e-4)


def test_mask_off_relu_kinks_drops_only_pairs_on_a_kink():
    """A pair is masked off exactly when one of its three ReLU inputs lies
    within the margin of 0 (relative to that input's max magnitude), and a
    query none of whose pairs was dropped keeps its output bit for bit."""
    from pointcloudpdf_tpu_torch.ops.vector_attention import (
        attention_preactivations, mask_off_relu_kinks)

    rng = np.random.RandomState(3)
    b, n, c, k = 2, 40, 32, 8
    g = c // 8

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale
                                 ).astype(np.float32))

    coord = t(b, n, 3)
    idx = torch.from_numpy(rng.randint(0, n, (b, n, k)))
    nmask = torch.from_numpy(rng.rand(b, n, k) > 0.1)
    feats = [t(b, n, c) for _ in range(3)]
    params = [t(3, 3), t(3), t(3, c), t(c), t(c, g, scale=0.3), t(g),
              t(g, g, scale=0.5), t(g), t(3), t(3), t(c), t(c), t(g), t(g)]
    margin = 1e-3
    cleared = mask_off_relu_kinks(*feats, coord, idx, nmask, *params,
                                  margin=margin)
    pres = attention_preactivations(*feats[:2], coord, idx, *params[:6],
                                    *params[8:])[1:]
    on_kink = torch.zeros_like(nmask)
    for pre in pres:
        on_kink |= (pre.abs() <= margin * pre.abs().max()).any(-1)
    assert torch.equal(cleared, nmask & ~on_kink)
    dropped = (nmask & on_kink).any(-1)
    assert dropped.any() and not dropped.all()
    out = vector_attention_train_plain(*feats, coord, idx, nmask, *params)
    out_cleared = vector_attention_train_plain(*feats, coord, idx, cleared, *params)
    assert torch.equal(out[~dropped], out_cleared[~dropped])
    assert not torch.equal(out[dropped], out_cleared[dropped])
