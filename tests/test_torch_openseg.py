"""The port's open-set training step against the JAX package on the CPU:
the recognizer's schedule, score sheets and loss, the copied host
pseudo-labelling pipeline (bit-identical masks), one ``OpenSegTrainer``
step past ``start_epoch`` (Seg26 + the PDF recognizer, weights through the
bridge), the frozen recognizer before ``start_epoch``, and the first
active step behind two frozen ones (the optimizer state that a frozen
recognizer gathers).
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.recognizers import build_recognizer as jax_build_recognizer
from pointcloudpdf_tpu.recognizers import pseudo_label as jax_pseudo
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.bridge import jax_to_state_dict, state_dict_to_jax
from pointcloudpdf_tpu_torch.engines.train import TRAINERS
from pointcloudpdf_tpu_torch.recognizers import build_recognizer
from pointcloudpdf_tpu_torch.recognizers import pseudo_label as port_pseudo
from pointcloudpdf_tpu_torch.utils.config import Config

from test_torch_train import (CFG, assert_gradients_close, assert_trees_close,
                              make_batch, perturbed_start, port_gradients,
                              record_gradients, recorded_gradients)

torch.set_num_threads(1)

RECOGNIZER = dict(
    type="PointPdf-v1m1",
    recognizer=dict(type="PointTransformer-Recognizer"),
    criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
    loss_weight=0.01, step_loss_weight=True, num_classes=5, start_epoch=1,
    kp_ball_radius=0.12, kp_max_neighbor=8, condition_from="msp", beta=1.5,
    seed_from="ml", seed_range=0.05, num_seed=5, slide_window=True,
    pseudo_jobs=1,
)
OPEN_CFG = dict(copy.deepcopy(CFG), recognizer=RECOGNIZER, unknown_label=[4],
                train=dict(type="OpenSegTrainer"))


def test_recognizer_schedule_matches_jax():
    rec, jrec = build_recognizer(RECOGNIZER), jax_build_recognizer(RECOGNIZER)
    for epoch in range(6):
        rec.set_epoch(epoch)
        assert rec.epoch == epoch
        assert rec.loss_weight(epoch) == jrec.loss_weight(epoch)
        assert rec.needs_pseudo(epoch) == jrec.needs_pseudo(epoch)
    assert [rec.loss_weight(e) for e in (0, 1, 2, 3)] == [
        0.0, pytest.approx(0.01), pytest.approx(0.01), pytest.approx(0.001)]


def test_pseudo_scores_and_rec_loss_match_jax():
    """Score sheets atol 1e-5; recognizer loss and K+1 softmax score 1e-5."""
    rng = np.random.RandomState(0)
    logits = (rng.standard_normal((2, 300, 5)) * 3).astype(np.float32)
    raw = rng.standard_normal((2, 300, 1)).astype(np.float32)
    mask = np.arange(300)[None, :] < np.array([300, 170])[:, None]
    pseudo = rng.randint(-1, 6, (2, 300)).astype(np.int64)
    rec, jrec = build_recognizer(RECOGNIZER), jax_build_recognizer(RECOGNIZER)
    msp, ml = rec.pseudo_scores(torch.from_numpy(logits), torch.from_numpy(mask))
    jmsp, jml = jrec.pseudo_scores(jnp.asarray(logits), jnp.asarray(mask))
    np.testing.assert_allclose(msp.numpy(), np.asarray(jmsp), atol=1e-5)
    np.testing.assert_allclose(ml.numpy()[mask], np.asarray(jml)[mask], atol=1e-5)
    loss = rec.rec_loss(torch.from_numpy(logits), torch.from_numpy(raw),
                        torch.from_numpy(pseudo))
    jloss = jrec.rec_loss(jnp.asarray(logits), jnp.asarray(raw), jnp.asarray(pseudo))
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    np.testing.assert_allclose(
        rec.score(torch.from_numpy(logits), torch.from_numpy(raw)).numpy(),
        np.asarray(jrec.score(jnp.asarray(logits), jnp.asarray(raw))), atol=1e-5)


@pytest.mark.parametrize("method", ["msp", "ml"])
def test_max_probability_matches_jax(method):
    logits = np.random.RandomState(1).standard_normal((2, 40, 5)).astype(np.float32)
    cfg = dict(type="MaxProbability", method=method)
    rec, jrec = build_recognizer(cfg), jax_build_recognizer(cfg)
    np.testing.assert_allclose(rec.score(torch.from_numpy(logits)).numpy(),
                               np.asarray(jrec.score(jnp.asarray(logits))), atol=1e-6)
    assert rec.loss_weight(3) == 0.0 and not rec.has_params


def test_open_seg_trainer_with_parameter_free_recognizer(tmp_path):
    """MaxProbability has no module: the joint step trains the backbone
    alone, the evaluator's forward scores with it, and the checkpoint keeps
    an empty recognizer subtree."""
    cfg = dict(copy.deepcopy(OPEN_CFG), save_path=str(tmp_path),
               recognizer=dict(type="MaxProbability", method="msp"))
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=Config(cfg)))
    batch = trainer.device_batch(make_batch(7, n=512, counts=(512, 300)))
    trainer._dispatch_train(batch, trainer.recognizer.loss_weight(0))
    out = trainer.comm_info["model_output_dict"]
    assert set(out) == {"seg_loss", "loss"} and np.isfinite(float(out["loss"]))
    scored = trainer.eval_step(batch)
    assert scored["score"].shape == (2, 512) and torch.isfinite(scored["score"]).all()
    state = trainer.state_dict()
    assert state["params"]["recognizer"] == {} and state["step"] == 1


def _clustered_scores(seed, b=2, n=600):
    """Scenes with a tight low-confidence corner cluster, as score sheets."""
    rng = np.random.RandomState(seed)
    coord = (rng.rand(b, n, 3) * 2.0).astype(np.float32)
    coord[:, :90] = (rng.rand(b, 90, 3) * 0.4).astype(np.float32)
    msp = (0.9 + 0.1 * rng.rand(b, n)).astype(np.float32)
    msp[:, :90] = (0.3 + 0.2 * rng.rand(b, 90)).astype(np.float32)
    ml = rng.rand(b, n).astype(np.float32)
    ml[:, :90] *= 0.2
    return coord, msp, ml, np.array([n, n - 130], np.int32)


def test_pseudo_label_copy_is_bit_identical():
    """The copied host pipeline (lazy cKDTree rows, mean-shift, MST, GMM,
    components) gives the JAX package's masks bit for bit on the same
    scores and seed."""
    coord, msp, ml, count = _clustered_scores(2)
    kwargs = dict(seed=11, n_jobs=1, scores=(msp, ml), ball_radius=0.15, ball_k=8,
                  condition_from="msp", beta=1.5, seed_from="ml",
                  seed_range=0.05, num_seed=5, slide_window=True)
    got = port_pseudo.pseudo_labeling_batch(coord, None, None, count, **kwargs)
    want = jax_pseudo.pseudo_labeling_batch(coord, None, None, count, **kwargs)
    assert got.dtype == want.dtype == bool and got.shape == (2, 600)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got[1, count[1]:].any()
    rec = build_recognizer(RECOGNIZER)
    via = rec.pseudo_masks_from_scores(coord, msp, ml, count, seed=11,
                                       ball_radius=np.full(2, 0.15))
    np.testing.assert_array_equal(via, got)


def build_pair(cfg):
    """Both trainers on one config, one seeded batch and a perturbed start."""
    jtrainer = JAX_TRAINERS.build(dict(type="OpenSegTrainer", cfg=JaxConfig(cfg)))
    trainer = TRAINERS.build(dict(type="OpenSegTrainer", cfg=Config(cfg)))
    record_gradients(jtrainer)
    np_batch = make_batch(4)
    rng = np.random.RandomState(5)
    np_batch["segment_pseudo"] = np.where(
        (rng.rand(*np_batch["segment"].shape) < 0.1) & (np_batch["segment"] >= 0),
        5, np_batch["segment"])
    jbatch = jtrainer.device_batch(np_batch)
    jtrainer.initialize_state(jbatch)
    start = perturbed_start(jtrainer, seed=6)
    return jtrainer, trainer, np_batch, jbatch, start


@pytest.fixture(scope="module")
def exact_knn():
    from pointcloudpdf_tpu.ops import geometry as jgeo

    old, jgeo.FORCE_KNN_PATH = jgeo.FORCE_KNN_PATH, "exact"
    yield
    jgeo.FORCE_KNN_PATH = old


@pytest.fixture(scope="module")
def built(tmp_path_factory, exact_knn):
    """Both trainers, built (and the JAX steps compiled) once."""
    return build_pair(dict(copy.deepcopy(OPEN_CFG),
                           save_path=str(tmp_path_factory.mktemp("open"))))


def reset_to_start(pair):
    """The two trainers reset to the shared seeded start, fresh optimizers."""
    from pointcloudpdf_tpu.parallel.mesh import replicate_tree

    jtrainer, trainer, np_batch, jbatch, start = pair
    jtrainer.state = replicate_tree(jtrainer.state.replace(
        params=start["params"], batch_stats=start["batch_stats"],
        opt_state=jtrainer.tx.init(start["params"]),  # holds the gradient too
        step=jnp.asarray(0, jnp.int32)), jtrainer.mesh)
    for name, module in trainer.modules().items():
        module.load_state_dict(jax_to_state_dict(
            {k: start[k][name] for k in start}), strict=True)
    trainer.optimizer = trainer.build_optimizer()
    trainer._host_step = 0
    return pair


@pytest.fixture
def trainers(built):
    return reset_to_start(built)


def test_open_seg_step_past_start_epoch_matches_jax(trainers):
    """Score pass: sheets atol 1e-5.  One joint step with the recognizer
    loss on: loss, seg_loss, loss_rec within 1e-4 relative; the gradient of
    every backbone and recognizer parameter as ``assert_gradients_close``
    holds it; backbone and recognizer parameters and running statistics
    within 1e-4 of each tensor's max |value|."""
    jtrainer, trainer, np_batch, jbatch, _ = trainers
    batch = trainer.device_batch(np_batch)
    msp, ml = trainer.pseudo_forward(batch)
    jmsp, jml = jtrainer._pseudo_forward(jtrainer.state, jbatch)
    valid = batch["mask"].numpy()
    np.testing.assert_allclose(msp.numpy(), np.asarray(jmsp), atol=1e-5)
    np.testing.assert_allclose(ml.numpy()[valid], np.asarray(jml)[valid], atol=1e-5)

    rec_w = trainer.recognizer.loss_weight(1)
    assert rec_w == pytest.approx(0.01)
    jtrainer.state, jout = jtrainer._train_step(
        jtrainer.state, jbatch, jax.random.PRNGKey(0), jnp.asarray(rec_w, jnp.float32))
    grads = port_gradients(trainer, lambda: trainer._dispatch_train(batch, rec_w))
    out = trainer.comm_info["model_output_dict"]
    print("gradients port-JAX: worst tensor %.3e, whole %.3e"
          % assert_gradients_close(grads, recorded_gradients(jtrainer), "gradients"))
    for key in ("loss", "seg_loss", "loss_rec"):
        assert float(out[key]) == pytest.approx(float(jout[key]), rel=1e-4), key
    state = trainer.state_dict()
    assert_trees_close(state["params"], jtrainer.state.params, 1e-4, "params")
    assert_trees_close(state["batch_stats"], jtrainer.state.batch_stats, 1e-4,
                       "batch_stats")
    moved = [p for p in trainer._rec_module.parameters() if p.grad is not None]
    assert len(moved) == len(list(trainer._rec_module.parameters()))


def test_recognizer_frozen_before_start_epoch(trainers):
    """With loss weight 0 a step (weight decay on) leaves the recognizer's
    parameters bit-unchanged in both packages and still reports loss_rec;
    the backbone moves, and its loss agrees with the JAX step."""
    jtrainer, trainer, np_batch, jbatch, start = trainers
    assert trainer.recognizer.loss_weight(0) == 0.0
    assert trainer.cfg.optimizer.weight_decay > 0
    jtrainer.state, jout = jtrainer._train_step(
        jtrainer.state, jbatch, jax.random.PRNGKey(0), jnp.asarray(0.0, jnp.float32))
    trainer._dispatch_train(trainer.device_batch(np_batch), 0.0)
    out = trainer.comm_info["model_output_dict"]
    assert float(out["loss"]) == pytest.approx(float(jout["loss"]), rel=1e-4)
    assert float(out["loss"]) == float(out["seg_loss"]) and "loss_rec" in out
    end = state_dict_to_jax(trainer._rec_module.state_dict())["params"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, end,
                           start["params"]["recognizer"])
    jax.tree_util.tree_map(
        np.testing.assert_array_equal,
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params["recognizer"]),
        start["params"]["recognizer"])
    before = start["params"]["model"]["backbone_module"]["cls2"]["kernel"]
    after = trainer.state_dict()["params"]["model"]["backbone_module"]["cls2"]["kernel"]
    assert np.abs(after - before).max() > 0


def test_active_step_behind_two_frozen_steps_matches_jax(tmp_path, exact_knn):
    """SGD with momentum 0.9 and weight decay at a rate where the optimizer
    state shows: while the recognizer is frozen its momentum trace gathers
    weight decay in both packages (the JAX step zeroes the recognizer's
    updates, not its gradients), so the first active step moves it by
    lr * 0.9 * trace more than a step from an empty state would (here
    1.7e-3 of each weight).  After two frozen steps and one active step the
    recognizer's parameters agree within 1e-5, and they stayed bit-unchanged
    through the frozen steps."""
    cfg = copy.deepcopy(OPEN_CFG)
    cfg.update(save_path=str(tmp_path),
               optimizer=dict(type="SGD", lr=0.02, momentum=0.9, weight_decay=0.05),
               scheduler=dict(type="MultiStepLR", milestones=[0.9], gamma=0.1))
    jtrainer, trainer, np_batch, jbatch, start = reset_to_start(build_pair(cfg))
    batch = trainer.device_batch(np_batch)
    rec_w = trainer.recognizer.loss_weight(1)
    for step, w in enumerate((0.0, 0.0, rec_w)):
        jtrainer.state, _ = jtrainer._train_step(
            jtrainer.state, jbatch, jax.random.PRNGKey(step),
            jnp.asarray(w, jnp.float32))
        trainer._dispatch_train(batch, w)
        if step == 1:
            frozen = state_dict_to_jax(trainer._rec_module.state_dict())["params"]
            jax.tree_util.tree_map(np.testing.assert_array_equal, frozen,
                                   start["params"]["recognizer"])
    got = state_dict_to_jax(trainer._rec_module.state_dict())["params"]
    ref = jax.tree_util.tree_map(np.asarray, jtrainer.state.params["recognizer"])
    moved = jax.tree_util.tree_map(lambda a, b: np.abs(a - b).max(), ref,
                                   start["params"]["recognizer"])
    assert max(jax.tree_util.tree_leaves(moved)) > 1e-3
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-5), got, ref)
