"""The port's PT-v2 training slice against the JAX package on the CPU: the
PT-v2m2 whole-network gradient under CE + Lovasz, PT-v2m3 (PDNorm) forward
for each condition and its gradient, three AdamW + ``MultiStepLR`` steps
through both packages' ``DefaultTrainer``, the bridge's PD banks and the
shipped configs that name the new pieces.  ``tools/train_torch.py --device
cpu`` on a PT-v2 config with ``PreciseEvaluator`` in the hooks is in
``test_torch_trainer.py``.

Inputs come from a numpy seed: ``test_torch_ptv2.cloud(40)``, whose kNN
tables are tie-free (asserted at every run: the JAX kNN's matmul-identity
distances could order a near-tie otherwise).  The JAX side runs unfused
(``FUSED_GVA = "off"``) with the exact kNN, in f32, drop path 0.
Tolerances: a whole forward 1e-4 x max |logit|, losses rtol 1e-4,
whole-network gradients as ``test_torch_cac_losses.assert_gradient_triple``
holds them (0.25 of a tensor's max, 0.05 in L2, port and JAX each against
the port's float64 gradient too).
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.models import build_model as jax_build_model
from pointcloudpdf_tpu.models.losses import build_criteria as jax_build_criteria
from pointcloudpdf_tpu.models.point_transformer_v2 import ptv2 as jptv2
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import (backbone_state_dict_to_jax,
                                            jax_to_backbone_state_dict,
                                            jax_to_state_dict, state_dict_to_jax)
from pointcloudpdf_tpu_torch.engines.hooks import HOOKS
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.models import build_model
from pointcloudpdf_tpu_torch.models.losses import build_criteria
from pointcloudpdf_tpu_torch.models.norm import PDMaskedBatchNorm
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_cac_losses import (BACKBONE, CONDITIONS, assert_gradient_triple,
                                   float64_gradients, grad_tree, port_weights,
                                   randomise_pd, seg_batch)
from test_torch_st import japply
from test_torch_st_train import knn_tie_gaps
from test_torch_train import (CFG, assert_trees_close, perturbed_start,
                              port_gradients, record_gradients,
                              recorded_gradients)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4   # x max |logit|
LOVASZ = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1),
          dict(type="LovaszLoss", mode="multiclass", loss_weight=1.0, ignore_index=-1)]
SEG = dict(type="DefaultSegmentor", backbone=dict(BACKBONE, num_classes=5),
           criteria=LOVASZ)
M3 = dict(BACKBONE, type="PT-v2m3", num_classes=5, norm_adaptive=True,
          context_channels=8, zero_init=False)


@pytest.fixture(scope="module", autouse=True)
def exact_jax_paths():
    old = (jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA)
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = "exact", "off"
    yield
    jgeo.FORCE_KNN_PATH, jptv2.FUSED_GVA = old


def tensors(batch):
    """numpy arrays -> tensors; anything else (a condition's name) as it is."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def tie_free(gaps, n):
    assert len(gaps) == n and min(gaps) >= 5e-7, gaps


# -- PT-v2m2 under CE + Lovasz ------------------------------------------------------------


def test_ptv2_gradient_with_lovasz_matches_jax():
    """One training forward and backward of a small PT-v2m2 under the
    Lovasz configs' criteria (CE + Lovasz), from a perturbed start: the
    loss rtol 1e-4, the gradient as ``assert_gradient_triple`` holds it
    (measured, worst tensor / whole: port-float64 6.8e-2 / 4.1e-3,
    JAX-float64 8.3e-2 / 2.2e-2, port-JAX 8.8e-2 / 2.2e-2)."""
    tree = port_weights(SEG, 33)
    batch = seg_batch(34)
    model = build_model(SEG)
    model.load_state_dict(jax_to_state_dict(tree), strict=True)
    jmodel = jax_build_model(SEG)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criteria = jax_build_criteria(LOVASZ)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": tree["batch_stats"]},
                              jbatch, train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return criteria(out["seg_logits"], jbatch["segment"])

    ref, ref_g = jax.jit(jax.value_and_grad(loss_fn))(tree["params"])
    truth = float64_gradients(model, batch,
                              lambda out, b: model.loss(out["seg_logits"], b["segment"]))
    with knn_tie_gaps() as gaps:
        out = model.train()(tensors(batch))
    tie_free(gaps, 3)
    loss = model.loss(out["seg_logits"], tensors(batch)["segment"])
    assert float(loss) == pytest.approx(float(ref), rel=1e-4)
    loss.backward()
    assert_gradient_triple(grad_tree(model), ref_g, truth, "PT-v2m2 CE + Lovasz")


# -- PT-v2m3 ---------------------------------------------------------------------------------


def m3_models(seed):
    """The JAX and port PT-v2m3 backbones on one set of weights: made on
    the port's side, every bank and the modulations randomised."""
    torch.manual_seed(seed)
    model = build_model(dict(M3))
    tree = randomise_pd(backbone_state_dict_to_jax(model.state_dict()),
                        np.random.RandomState(seed))
    model.load_state_dict(jax_to_backbone_state_dict(tree), strict=True)
    return jax_build_model(dict(M3)), model, tree


def m3_batch(seed):
    batch = seg_batch(seed)
    batch["context"] = np.random.RandomState(seed).standard_normal((1, 8)).astype(np.float32)
    return batch


def test_ptv2m3_forward_matches_jax_for_each_condition():
    """Eval, adaptive PDNorm with a non-zero modulation: each condition's
    logits within 1e-4 x max |logit| of JAX's (the port takes the
    condition from ``forward``'s argument, and from the batch's
    ``condition_name`` as the JAX module does); the three conditions give
    three different outputs."""
    jmodel, model, tree = m3_models(41)
    batch = m3_batch(42)
    jbatch = {k: v for k, v in batch.items() if k != "segment"}
    model.eval()
    outs = []
    for condition in CONDITIONS:
        ref = np.asarray(japply(jmodel, tree, jbatch, train=False, condition=condition))
        with knn_tie_gaps() as gaps, torch.inference_mode():
            got = model(tensors(jbatch), condition=condition).numpy()
        tie_free(gaps, 3)
        assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), condition
        outs.append(got)
    with torch.inference_mode():
        named = model(tensors(dict(jbatch, condition_name=CONDITIONS[2]))).numpy()
    np.testing.assert_array_equal(named, outs[2])
    assert np.abs(outs[0] - outs[1]).max() > 1e-2 and np.abs(outs[1] - outs[2]).max() > 1e-2
    with pytest.raises(ValueError, match="condition"):
        model(tensors(jbatch))


def test_ptv2m3_gradient_and_banks_match_jax():
    """Training under ``S3DIS``: the CE loss of the logits rtol 1e-4, the
    gradient as ``assert_gradient_triple`` holds it (the inactive banks'
    rows 0 on both sides), the running statistics within rtol 1e-5 / atol
    1e-5 of JAX's, and only the active bank's statistics moved: every other
    bank bit-equal to its start (measured, worst tensor / whole:
    port-float64 1.6e-2 / 3.3e-4, JAX-float64 6.4e-2 / 2.8e-3, port-JAX
    6.5e-2 / 2.8e-3)."""
    jmodel, model, tree = m3_models(43)
    batch = m3_batch(44)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    criteria = jax_build_criteria(LOVASZ[:1])

    stats0 = jax.tree_util.tree_map(jnp.asarray, tree["batch_stats"])

    def loss_fn(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats0},
                                jbatch, train=True, condition="S3DIS",
                                mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return criteria(out, jbatch["segment"]), mut

    (ref, mut), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree["params"])
    loss_of = build_criteria(LOVASZ[:1])
    start = {k: v.clone() for k, v in model.state_dict().items()}
    named = dict(batch, condition_name="S3DIS")
    truth = float64_gradients(model, named, lambda out, b: loss_of(out, b["segment"]),
                              backbone_state_dict_to_jax)
    with knn_tie_gaps() as gaps:
        loss = loss_of(model.train()(tensors(named)), tensors(batch)["segment"])
    tie_free(gaps, 3)
    assert float(loss) == pytest.approx(float(ref), rel=1e-4)
    loss.backward()
    grads = grad_tree(model, to_jax=backbone_state_dict_to_jax)
    assert_gradient_triple(grads, ref_g, truth, "PT-v2m3")
    scale = flatten_tree(grads)["enc0_blocks/block0/norm1/scale"]
    assert (scale[[0, 2]] == 0).all() and np.abs(scale[1]).max() > 0
    stats = flatten_tree(backbone_state_dict_to_jax(model.state_dict())["batch_stats"])
    for path, r in flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                       mut["batch_stats"])).items():
        np.testing.assert_allclose(stats[path], r, rtol=1e-5, atol=1e-5, err_msg=path)
    moved = 0
    for key, t in model.state_dict().items():
        if "running" in key:
            same = torch.equal(t, start[key])
            assert same != (".bns.1." in key), key
            moved += not same
    assert moved == 2 * sum(isinstance(m, PDMaskedBatchNorm) for m in model.modules())


def test_ptv2m3_bridge_round_trip_bit_equal():
    """Decoupled (three banks a norm, the adaptive modulation) and shared
    (one ``bn`` a norm): the tree has the JAX model's names and shapes,
    every bank included; JAX tree -> state_dict -> JAX tree is bit-equal and
    loads with strict=True."""
    batch = {k: jnp.asarray(v) for k, v in m3_batch(45).items() if k != "segment"}
    for cfg in (M3, dict(M3, norm_decouple=False, norm_adaptive=False)):
        torch.manual_seed(46)
        model = build_model(dict(cfg))
        tree = randomise_pd(backbone_state_dict_to_jax(model.state_dict()),
                            np.random.RandomState(46))
        shapes = jax.eval_shape(lambda: jax_build_model(dict(cfg)).init(
            {"params": jax.random.PRNGKey(0)}, batch, train=False, condition="S3DIS"))
        for coll in ("params", "batch_stats"):
            want = {k: tuple(s.shape) for k, s in flatten_tree(dict(shapes[coll])).items()}
            assert {k: a.shape for k, a in flatten_tree(tree[coll]).items()} == want
        sd = jax_to_backbone_state_dict(tree)
        model.load_state_dict(sd, strict=True)
        if cfg.get("norm_decouple", True):
            assert sd["enc_stages.0.blocks.blocks.0.norm1.bns.2.running_var"].shape == (16,)
            assert sd["seg_head.1.modulation.1.weight"].shape == (32, 8)
        else:
            assert "enc_stages.0.blocks.blocks.0.norm1.bn.weight" in model.state_dict()
        back = backbone_state_dict_to_jax(model.state_dict())
        for coll in ("params", "batch_stats"):
            a, b = flatten_tree(tree[coll]), flatten_tree(back[coll])
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])


# -- three AdamW steps through the trainers ---------------------------------------------------


def test_three_adamw_steps_match_jax_trainer(tmp_path):
    """A small PT-v2m2 under CE + Lovasz through both packages'
    ``DefaultTrainer``: AdamW (weight decay 0.05) with ``MultiStepLR``
    dropping the rate at step 2, drop path 0, one padded batch (the second
    sample's tail masked), from a perturbed shared start.  Each step's loss
    within 1e-4 relative and its rate equal to the JAX schedule's; the first
    step's gradient as ``assert_gradient_triple`` holds it; after it, the
    BatchNorm running statistics within 1e-4 of each tensor's max, and the
    move of every parameter element whose gradient is clear of noise
    (Adam's first step is ~ lr x sign) equal to JAX's within 2% of the rate
    and two float32 spacings; after the third step, parameters and
    statistics within 1e-2 of each tensor's max (and an element whose
    first gradient was noise within 2 x the rates' sum more: Adam moves it
    by the noise's sign; a running mean within a tenth of that more)."""
    cfg = dict(copy.deepcopy(CFG), save_path=str(tmp_path), model=copy.deepcopy(SEG),
               optimizer=dict(type="AdamW", lr=0.0005, weight_decay=0.05))
    jtrainer = JAX_TRAINERS.build(dict(type="DefaultTrainer", cfg=JaxConfig(cfg)))
    trainer = TRAINERS.build(dict(type="DefaultTrainer", cfg=Config(cfg)))
    record_gradients(jtrainer)
    batch = seg_batch(35)
    np_batch = dict(coord=batch["coord"], feat=batch["feat"], segment=batch["segment"],
                    count=batch["mask"].sum(1).astype(np.int32))
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    start = perturbed_start(jtrainer, seed=36)
    trainer.model.load_state_dict(jax_to_state_dict(start), strict=True)
    truth = float64_gradients(
        trainer.model, trainer.device_batch(np_batch),
        lambda out, b: trainer.model.loss(out["seg_logits"], b["segment"]))

    lrs, noise = [], {}
    for step in range(3):
        rng = jax.random.fold_in(jtrainer._base_rng, step + 1)
        jtrainer.state, jout = jtrainer._train_step(jtrainer.state, jbatch, rng)
        trainer.comm_info["input_dict"] = np_batch
        with knn_tie_gaps() as gaps:
            grads = port_gradients(trainer, trainer.run_step)
        tie_free(gaps, 3)
        out = trainer.comm_info["model_output_dict"]
        assert set(out) == {"loss"}
        assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4), step
        lr = trainer.comm_info["lr"]
        assert lr == pytest.approx(float(jtrainer.scheduler(step)), abs=1e-12)
        lrs.append(lr)
        state = state_dict_to_jax(trainer.model.state_dict())
        if step == 0:
            jgrads = recorded_gradients(jtrainer)
            assert_gradient_triple(grads, jgrads, truth, "three AdamW steps, step 1")
            assert_trees_close(state["batch_stats"], jtrainer.state.batch_stats, 1e-4,
                               "batch_stats")
            got, ref = flatten_tree(state["params"]), flatten_tree(
                jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
            first, jg = flatten_tree(start["params"]), flatten_tree(
                jax.tree_util.tree_map(np.asarray, jgrads))
            checked = 0
            for path, g in jg.items():
                scale = max([np.abs(g).max()] + [
                    np.abs(jg[path[:-4] + s]).max() for s in ("kernel", "scale")
                    if path.endswith("/bias") and path[:-4] + s in jg])
                clear = np.abs(g) > 1e-2 * scale
                noise[path] = ~clear
                d_port = (got[path] - first[path])[clear]
                d_jax = (ref[path] - first[path])[clear]
                ulp = np.spacing(np.abs(first[path][clear]))
                assert (np.abs(d_port - d_jax) <= 0.02 * lr + 2 * ulp).all(), path
                checked += int(clear.sum())
            assert checked > 1000
    # Adam moves an element by ~ lr x the sign of its gradient whatever the
    # gradient's size: where the first step's gradient is noise (a bias
    # ahead of a batch-statistic BatchNorm or the softmax, exactly 0) the
    # two runs may part by 2 lr a step
    got, ref = flatten_tree(state["params"]), flatten_tree(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for path, r in ref.items():
        allowed = 1e-2 * np.abs(r).max() + np.where(noise[path], 2 * sum(lrs), 0.0)
        assert (np.abs(got[path] - r) <= allowed).all(), path
    # ... and a running mean takes a tenth (momentum 0.1) of its input's
    # shift, which such a bias ahead of it is
    got, ref = flatten_tree(state["batch_stats"]), flatten_tree(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.batch_stats))
    for path, r in ref.items():
        allowed = 1e-2 * np.abs(r).max() + (0.2 * sum(lrs) if path.endswith("mean") else 0)
        assert (np.abs(got[path] - r) <= allowed).all(), path
    assert lrs == pytest.approx([0.0005, 0.0005, 0.0005 * 0.1])
    assert trainer.state_dict()["step"] == 3


# -- the shipped configs ---------------------------------------------------------------------


@pytest.mark.parametrize("path", [
    "s3dis/semseg-pt-v2m2-0-lovasz.py", "scannet/semseg-pt-v2m2-3-lovasz.py",
    "scannet200/semseg-pt-v2m2-2-lovasz.py", "scannet/semseg-cac-v1m1-2-ptv2-lovasz.py",
    "scannet/semseg-pt-v2m2-2-precise-evaluate.py", "s3dis/semseg-pt-v2m2-1-one-cycle.py"])
def test_shipped_configs_build(path):
    """Every shipped config that names a piece of this slice builds it in
    the port: the Lovasz criteria, CAC-v1m1 over PT-v2m2 at full width (the
    same parameter and statistics shapes, names and all, as the JAX tree's),
    PreciseEvaluator among the hooks; the one-cycle config's optimizer and
    schedule."""
    from pointcloudpdf_tpu_torch.utils.optimizer import build_optimizer
    from pointcloudpdf_tpu_torch.utils.scheduler import build_scheduler

    cfg = Config.fromfile(os.path.join(ROOT, "configs", path))
    criteria = build_criteria(cfg.model.criteria)
    names = [type(c).__name__ for c in criteria.criteria]
    assert names == (["CrossEntropyLoss", "LovaszLoss"] if "lovasz" in path
                     else ["CrossEntropyLoss"])
    hooks = [HOOKS.build(dict(h)) for h in cfg.hooks]
    assert ("PreciseEvaluator" in [type(h).__name__ for h in hooks]) == (
        "precise" in path)
    if "cac" in path:
        model = build_model(dict(cfg.model))
        assert type(model).__name__ == "CACSegmentor"
        tree = state_dict_to_jax(model.state_dict())
        n = 1024
        batch = dict(coord=jnp.zeros((1, n, 3)), feat=jnp.zeros((1, n, 9)),
                     mask=jnp.ones((1, n), bool), segment=jnp.zeros((1, n), jnp.int32))
        shapes = jax.eval_shape(lambda: jax_build_model(
            JaxConfig.fromfile(os.path.join(ROOT, "configs", path)).model).init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
            batch, train=True))
        for coll in ("params", "batch_stats"):
            want = {k: tuple(s.shape) for k, s in flatten_tree(dict(shapes[coll])).items()}
            assert {k: a.shape for k, a in flatten_tree(tree[coll]).items()} == want
    if "one-cycle" in path:
        model = build_model(dict(cfg.model))
        opt = build_optimizer(dict(cfg.optimizer), model.named_parameters(),
                              param_dicts=cfg.param_dicts)
        low = opt.param_groups[1]["params"]
        blocks = [p for n, p in model.named_parameters() if "block" in n]
        assert len(low) == len(blocks) > 0 and opt.param_groups[1]["lr"] == 0.0006
        sched = build_scheduler(dict(cfg.scheduler), cfg.optimizer.lr, 1000)
        lrs = [float(sched(s)) for s in (0, 50, 999)]
        assert lrs[0] == pytest.approx(0.0006) and lrs[1] == pytest.approx(0.006, rel=1e-4)
        assert lrs[2] < 1e-5
