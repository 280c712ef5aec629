"""The port's data-parallel half on the CPU: ``launch`` with two gloo ranks
against one process on the global batch, and against the JAX package.

A run of W ranks on a global batch must compute what one process computes
on it, up to the order of float sums (the JAX package's semantics under
GSPMD): the losses, the gradient the optimizer is handed, the BatchNorm
running statistics and the metrics.  The ranks (``torch_ddp_ranks.py``,
spawned once for the module) take items ``rank::2`` of every global batch,
as the loader's shards do, and this process runs the same functions on the
whole batch.  Covered: ``comm`` at world 2; the loader's shards; the synced
masked BatchNorms and the attention stats pass; the globally normalised
losses with one rank mostly padding; Lovasz, which stays per rank; three
``OpenSegTrainer`` steps across the frozen -> active recognizer switch
(pseudo-label masks bit-equal), held against one process and against the
JAX trainer on its 8-device mesh; a PT-v2m2 ``DefaultTrainer`` step and an
``IncrSegTrainer`` step; the gradient in float64; ``tools/train_torch.py``
and ``tools/test_torch.py`` with ``--num-gpus 2 --device cpu``; world 1
through ``launch`` bit-equal to a run without it; a failing rank.

Mix3D is off (``mix_prob = 0``): it pairs crops within a rank's batch, so a
mixed global batch is another batch at another world.
"""

import contextlib
import copy
import os
import pickle
import re
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pointcloudpdf_tpu.datasets import DATASETS as JAX_DATASETS
from pointcloudpdf_tpu.engines.train import TRAINERS as JAX_TRAINERS
from pointcloudpdf_tpu.ops import geometry as jgeo
from pointcloudpdf_tpu.utils.config import Config as JaxConfig
from pointcloudpdf_tpu_torch.datasets.loader import DataLoader
from pointcloudpdf_tpu_torch.engines.launch import launch
from pointcloudpdf_tpu_torch.engines.train import step_seed
from pointcloudpdf_tpu_torch.recognizers import build_recognizer
from pointcloudpdf_tpu_torch.utils import comm
from pointcloudpdf_tpu_torch.utils.checkpoint import flatten_tree, load_checkpoint

import torch_ddp_ranks as ranks
from test_torch_cac_losses import assert_gradient_triple
from test_torch_train import (assert_gradients_close, assert_trees_close,
                              record_gradients, recorded_gradients)
from test_torch_trainer import ROOT, _run_tool, _scene

torch.set_num_threads(1)
JAX_DATASETS.register_module("DdpParityDataset", module=ranks._EightScenes, force=True)

WORLD = 2


class _Ranks:
    """The two ranks' results, computed in a thread while this process
    computes the one-process references."""

    def __init__(self, out):
        self.out, self.error = out, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            launch(ranks.run_ranks, num_gpus_per_machine=WORLD, cfg=(str(self.out),),
                   backend="gloo", device="cpu")
        except Exception as e:  # raised again in the test that reads it
            self.error = e

    def __getitem__(self, key):
        self.thread.join(timeout=600)
        assert not self.thread.is_alive(), "the ranks did not finish"
        if self.error is not None:
            raise self.error
        if not hasattr(self, "results"):
            self.results = []
            for r in range(WORLD):
                with open(self.out / f"rank{r}.pkl", "rb") as f:
                    self.results.append(pickle.load(f))
        return [res[key] for res in self.results]


@pytest.fixture(scope="module", autouse=True)
def world2(tmp_path_factory):
    return _Ranks(tmp_path_factory.mktemp("ddp_ranks"))


_REFERENCES = {}


def reference(key):
    """The one-process result of a rank check, on the whole batch."""
    if key not in _REFERENCES:
        fn, *args = ranks.CHECKS[key]
        _REFERENCES[key] = fn(*args, 0, 1)
    return _REFERENCES[key]


def interleave(parts):
    """Rank r's j-th item back to item j * world + r of the global batch."""
    out = np.empty((sum(len(p) for p in parts),) + parts[0].shape[1:], parts[0].dtype)
    for r, part in enumerate(parts):
        out[r::len(parts)] = part
    return out


def assert_stats_close(tree, ref_tree, tol, what):
    """Running statistics within ``tol`` of the reference's, of each
    tensor's max |value| but never finer than ``tol`` itself (a running
    mean near 0 moves by the rounding of its input's sums)."""
    flat, ref = flatten_tree(tree), flatten_tree(ref_tree)
    assert set(flat) == set(ref)
    for path, r in ref.items():
        err = np.abs(flat[path] - r).max()
        assert err <= tol * max(1.0, np.abs(r).max()), (what, path, err)


def assert_close(got, ref, tol=1e-5, what=""):
    """Within ``tol`` of the reference elementwise, relative to each value
    and to the tensor's max |value|."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max(),
                               err_msg=what)


# -- the loader ----------------------------------------------------------------------


class _Indices:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return i


@pytest.mark.parametrize("n", [16, 18])
def test_loader_shards_union_is_the_global_batch(n):
    """Step k's union over the ranks is one process's global batch k, over
    two epochs (``set_epoch`` reshuffles), and rank r's j-th item is item
    j * world + r of it: the order the pseudo-label seeds follow."""
    def loader(batch_size, shard_id, num_shards):
        return DataLoader(_Indices(n), batch_size=batch_size, shuffle=True,
                          drop_last=True, collate_fn=np.asarray, seed=5,
                          shard_id=shard_id, num_shards=num_shards)

    one = loader(4, 0, 1)
    shards = [loader(4 // WORLD, r, WORLD) for r in range(WORLD)]
    orders = []
    for epoch in range(2):
        for ld in (one, *shards):
            ld.set_epoch(epoch)
        steps = list(one)
        assert len(steps) == n // 4 and all(len(s) == len(steps) for s in shards)
        for k, batch in enumerate(steps):
            np.testing.assert_array_equal(interleave([list(s)[k] for s in shards]),
                                          batch)
        orders.append(np.concatenate(steps))
    assert not np.array_equal(*orders)


# -- world 1 through launch, and a failing rank ------------------------------------------


def _steps_in(out):
    out.append(ranks.open_seg_steps(comm.get_rank(), comm.get_world_size()))
    assert comm.is_distributed() and comm.get_world_size() == 1


def test_world_one_through_launch_is_bit_equal():
    """At world 1 with a backend, ``launch`` runs inline in a group of one
    and every collective of the path is issued: the three open-set steps
    give today's losses, pseudo-labels, gradient and state bit for bit.
    Without a backend it issues none.  Rank 0's drop-path stream is a
    one-process run's."""
    got = []
    launch(_steps_in, num_gpus_per_machine=1, cfg=(got,), backend="gloo",
           device="cpu")
    assert not comm.is_distributed()
    ref = reference("open_seg")
    for a, b in zip(got[0]["steps"], ref["steps"]):
        assert a["out"] == b["out"]
        np.testing.assert_array_equal(a["segment_pseudo"], b["segment_pseudo"])
        for coll in ("params", "batch_stats"):
            fa, fb = flatten_tree(a["state"][coll]), flatten_tree(b["state"][coll])
            for path in fb:
                np.testing.assert_array_equal(fa[path], fb[path], err_msg=path)
    fa, fb = flatten_tree(got[0]["steps"][0]["grads"]), flatten_tree(ref["steps"][0]["grads"])
    for path in fb:
        np.testing.assert_array_equal(fa[path], fb[path], err_msg=path)
    for seed, step in ((0, 0), (3, 7), (2024, 123456)):
        want = np.random.SeedSequence([seed, step + 1]).generate_state(1, np.uint64)
        assert step_seed(seed, step, rank=0) == step_seed(seed, step)
        assert step_seed(seed, step) == int(want[0]) & ((1 << 63) - 1)
        assert step_seed(seed, step, rank=1) != step_seed(seed, step)


def test_a_failing_rank_ends_the_run():
    """Rank 1 raises while rank 0 waits for it at a barrier: ``launch``
    raises (rank 1's error, or rank 0's lost connection to it, whichever
    the join sees first) and does not hang."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails|Connection reset|Connection closed"):
        launch(ranks.fail_on_rank_one, num_gpus_per_machine=WORLD, backend="gloo",
               device="cpu")
    assert not comm.is_distributed()


# -- the entry points -------------------------------------------------------------------

_CLI_CONFIG = '''
_base_ = [{base!r}]
batch_size = 4
num_worker = 0
enable_amp = False
seed = 7
unknown_label = [3]
model = dict(backbone=dict(type="PointTransformer-Seg26", num_classes=4))
recognizer = dict(num_classes=4, start_epoch=1, kp_ball_radius=0.25,
                  kp_max_neighbor=8, seed_range=0.05, num_seed=5, pseudo_jobs=1)
epoch = 3
eval_epoch = 3
optimizer = dict(lr=0.0001)
_tf = [
    dict(type="NormalizeColor", mode="zeroOne"),
    dict(type="MaskLabel", mask_label=unknown_label),
    dict(type="ToTensor"),
    dict(type="Collect", keys=("coord", "segment", "segment_known"),
         feat_keys=("coord", "color")),
]
data = dict(
    num_classes=4, names=["a", "b", "c", "unk"],
    train=dict(split="Area_1", data_root={data_root!r}, transform=_tf),
    val=dict(split="Area_4", data_root={data_root!r}, transform=_tf),
    test=dict(split="Area_5", data_root={data_root!r}, unknown_label=unknown_label,
              test_cfg=dict(voxelize=dict(grid_size=0.05),
                            post_transform=[
                                dict(type="ToTensor"),
                                dict(type="Collect", keys=("coord", "grid_coord", "index"),
                                     feat_keys=("coord", "color"))],
                            aug_transform=[[dict(type="RandomScale", scale=[1, 1])]])),
)
'''


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The shipped S3DIS PT-v1 open-set config at Seg26 over a synthetic
    tree, its train transforms without random draws (a rank's augmentation
    draws are its own): ``tools/train_torch.py`` at world 1 and world 2."""
    root = tmp_path_factory.mktemp("ddp_cli")
    rng = np.random.RandomState(0)
    for area, count in (("Area_1", 4), ("Area_4", 2), ("Area_5", 3)):
        os.makedirs(root / "s3dis" / area)
        for i in range(count):
            np.savez(root / "s3dis" / area / f"room_{i}.npz",
                     **_scene(rng, int(rng.uniform(300, 420))))
    config = root / "openseg-seg26.py"
    config.write_text(_CLI_CONFIG.format(
        base=os.path.join(ROOT, "configs", "s3dis", "openseg-pt-v1-0-pointpdf-v1m1-base.py"),
        data_root=str(root / "s3dis")))
    runs = {}
    for world in (1, WORLD):
        save = root / f"train_w{world}"
        with one_thread_a_rank():
            log = _run_tool("train_torch.py", [
                "--config-file", str(config), "--device", "cpu",
                "--num-gpus", str(world), "--options", f"save_path={save}"])
        runs[world] = dict(save=save, log=log if world == 1 else
                           (save / "train.log").read_text())
    return dict(root=root, config=str(config), runs=runs)


@contextlib.contextmanager
def one_thread_a_rank():
    """Spawned ranks start with one thread, as the tests run beside each
    other."""
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old


def _train_lines(log):
    return re.findall(r"Train: \[\d+/\d+\]\[\d+/\d+\] .*", log)


def test_train_tool_on_two_ranks_matches_one_process(cli):
    """``tools/train_torch.py --num-gpus 2 --device cpu``: three steps (the
    last two past ``start_epoch``) and three evaluations on two gloo ranks.
    The logged losses and pseudo-label shares equal one process's (to
    their four printed decimals); the evaluations' metrics within 1e-2 and
    the checkpoint rank 0 saved within 1e-2 of one process's (parameters
    and running statistics, of each tensor's max, a bias of its layer's).
    The two runs' weights part by float32 rounding from the first step on,
    as two packages' do (``test_torch_train`` holds port and JAX within
    1e-2 after three steps): AUPR ranks ~800 val points by score, and two
    that swap move it by ~1e-3 (2e-4 measured); a room of ~400 points
    keeps about two at the deepest level, whose BatchNorm variance then
    moves by ~1e-3 (measured).  The steps themselves are held tightly in
    ``test_open_seg_steps_match_one_process``."""
    one, two = (cli["runs"][w] for w in (1, WORLD))
    lines = [_train_lines(r["log"]) for r in (one, two)]
    assert len(lines[0]) == len(lines[1]) == 3
    number = r"(\w+): ([0-9.eE+-]+)"
    for a, b in zip(*lines):
        va, vb = dict(re.findall(number, a)), dict(re.findall(number, b))
        assert set(va) == set(vb) and "loss" in va
        for key in ("loss", "seg_loss", "loss_rec", "pseudo_flagged"):
            if key in va:
                assert abs(float(va[key]) - float(vb[key])) <= 1e-4, (key, a, b)
    assert "pseudo_flagged" in lines[1][-1]
    val = [re.findall(r"Val result: .*", r["log"]) for r in (one, two)]
    assert len(val[0]) == len(val[1]) == 6
    for a, b in zip(*val):
        va, vb = (np.array(re.findall(r"\d\.\d{4}", line), float) for line in (a, b))
        assert va.shape == vb.shape and np.abs(va - vb).max() <= 1e-2, (a, b)
    states = [load_checkpoint(os.path.join(r["save"], "model", "model_last.pth"))
              for r in (one, two)]
    assert states[0]["state"]["step"] == states[1]["state"]["step"] == 3
    for coll in ("params", "batch_stats"):
        got, ref = (flatten_tree(s["state"][coll]) for s in states[::-1])
        assert set(got) == set(ref)
        for path, r in ref.items():
            # a bias at its layer's scale: one ahead of a batch-statistic
            # BatchNorm has a gradient of exactly 0, and moves by noise
            scale = max([np.abs(r).max()] + [
                np.abs(ref[path[:-4] + s]).max() for s in ("kernel", "scale")
                if path.endswith("/bias") and path[:-4] + s in ref])
            assert np.abs(got[path] - r).max() <= 1e-2 * scale, (coll, path)


def test_test_tool_on_two_ranks_matches_one_process(cli):
    """``tools/test_torch.py --num-gpus 2 --device cpu`` (``OpenSegTester``)
    over three rooms, one process's checkpoint: rank 0 tests rooms 0 and
    2, rank 1 room 1; the pred and score files equal one process's bit for
    bit, and rank 0 reports the same metrics."""
    weight = os.path.join(cli["runs"][1]["save"], "model", "model_last.pth")
    logs, results = {}, {}
    for world in (1, WORLD):
        save = cli["root"] / f"test_w{world}"
        with one_thread_a_rank():
            log = _run_tool("test_torch.py", [
                "--config-file", cli["config"], "--device", "cpu",
                "--num-gpus", str(world), "--options", f"save_path={save}",
                f"weight={weight}"])
        logs[world] = log if world == 1 else (save / "train.log").read_text()
        results[world] = save / "result"
    names = sorted(os.listdir(results[1]))
    assert len([n for n in names if n.endswith("_pred.npy")]) == 3
    assert sorted(os.listdir(results[WORLD])) == names
    for name in names:
        np.testing.assert_array_equal(np.load(results[WORLD] / name),
                                      np.load(results[1] / name), err_msg=name)
    val = [re.findall(r"Val result: .*", logs[w]) for w in (1, WORLD)]
    assert len(val[0]) == 3 and val[0] == val[1]
    assert re.findall(r"Class_\d+ - .*", logs[1]) == re.findall(r"Class_\d+ - .*",
                                                                logs[WORLD])


# -- comm ------------------------------------------------------------------------------


def test_comm_at_world_two(world2):
    """Rank, world, local rank, barrier, ``all_gather`` / ``gather`` of
    objects, ``reduce_dict``, ``shared_random_seed``, the tensor sum (and
    its gradient: every rank's loss reaches every rank's input) and the
    broadcast; and the single-process answers outside a group."""
    got = world2["comm"]
    assert [g["rank"] for g in got] == [0, 1] and {g["world"] for g in got} == {2}
    assert [g["local_rank"] for g in got] == [0, 1]
    assert [g["main"] for g in got] == [True, False]
    for g in got:
        assert [x["rank"] for x in g["gathered"]] == [0, 1]
        np.testing.assert_array_equal(g["gathered"][1]["items"], np.arange(3))
        assert g["reduced"] == {"a": 1.5, "b": 1.0} and g["reduced_sum"] == {"a": 3.0}
        np.testing.assert_array_equal(g["summed"], [2.0, 1.0])
        np.testing.assert_array_equal(g["broadcast"], [5.0])
    assert got[0]["gather"] == [0, 10] and got[1]["gather"] == []
    assert got[0]["seed"] == got[1]["seed"]
    # loss_r = (x_0^2 + x_1^2) (r + 1): d/dx_r of the sum is 2 x_r (1 + 2)
    assert [g["x_grad"] for g in got] == [6.0, 12.0]
    assert not comm.is_distributed() and comm.get_world_size() == 1
    assert comm.all_gather(3) == [3] and comm.gather(3) == [3]
    t = torch.ones(2, requires_grad=True)
    assert comm.sum_over_ranks(t) is t and comm.rank_share(t) is t


# -- statistics and losses ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["bn", "pd"])
def test_masked_norms_match_one_process(world2, kind):
    """``MaskedBatchNorm`` and ``PDMaskedBatchNorm`` (a decoupled bank,
    adaptive) in training mode on two ranks against one process on the
    concatenated batch, rtol 1e-5: the output and the input gradient of
    each rank's items, the parameter gradients summed over the ranks, and
    the running statistics, equal on both ranks."""
    got, ref = world2[f"norm.{kind}"], reference(f"norm.{kind}")
    for key, want in ref.items():
        parts = [g[key] for g in got]
        if key in ("y", "x_grad"):
            assert_close(interleave(parts), want, what=key)
        elif key.startswith("grad."):
            assert_close(parts[0] + parts[1], want, what=key)
        else:
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=key)
            assert_close(parts[0], want, what=key)


def test_attention_stats_pass_matches_one_process(world2):
    """``attention_train_affines``, the statistics pass beside K4 (the
    plain PyTorch the CUDA path runs), on two ranks against one process:
    the six affines (equal on both ranks), the gradients of the inputs and
    of the weights, and the three BatchNorms' running statistics, rtol
    1e-5."""
    got, ref = world2["affines"], reference("affines")
    for key, want in ref.items():
        parts = [g[key] for g in got]
        if key in ("x_q_grad", "x_k_grad"):
            assert_close(interleave(parts), want, what=key)
        elif key.startswith("grad."):
            assert_close(parts[0] + parts[1], want, what=key)
        else:
            np.testing.assert_array_equal(parts[0], parts[1], err_msg=key)
            assert_close(parts[0], want, what=key)


@pytest.mark.parametrize("name", ["ce", "ce_smooth", "smooth_ce", "focal", "dice",
                                  "binary_focal", "kl", "pdf"])
def test_losses_match_one_process(world2, name):
    """Each loss with rank 0 holding a whole item and rank 1 an item of 10
    valid points in 64: the ranks' losses sum to the one-process loss (rtol
    1e-5) and each rank's logit gradient is its rows of the one-process
    gradient.  A mean over points divides by the global weight count; Dice
    sums its class statistics over the ranks."""
    got, ref = world2[f"loss.{name}"], reference(f"loss.{name}")
    assert sum(g["loss"] for g in got) == pytest.approx(ref["loss"], rel=1e-5)
    assert_close(interleave([g["grad"] for g in got]), ref["grad"])


def test_lovasz_stays_per_rank(world2):
    """Lovasz sorts its batch's errors, so it is no sum of per-point terms:
    each rank takes its own batch's, as in the reference's DDP, and the
    ranks' losses sum to their mean (the gradient likewise), where the JAX
    package's Lovasz under GSPMD is the global batch's.  The gap here is
    recorded, not bounded."""
    got = world2["loss.lovasz"]
    own = [ranks.check_loss("lovasz", r, WORLD) for r in range(WORLD)]
    per_rank = np.mean([o["loss"] for o in own])
    assert sum(g["loss"] for g in got) == pytest.approx(per_rank, rel=1e-6)
    for g, o in zip(got, own):
        assert_close(g["grad"], o["grad"] / WORLD, tol=1e-6)
    glob = reference("loss.lovasz")["loss"]
    print(f"Lovasz: mean of the ranks' {per_rank:.6f}, the global batch's "
          f"{glob:.6f}, gap {abs(per_rank - glob):.3e}")
    assert abs(per_rank - glob) > 1e-4


# -- trainer steps -------------------------------------------------------------------


def steps_of(result):
    return result["steps"] if isinstance(result, dict) else result


def assert_steps_match(got, ref, stats_tol=1e-4):
    """Per step: the logged outputs equal on both ranks and within 1e-5
    relative of one process's; the pseudo-labels trained on bit-equal; the
    parameters and running statistics equal on both ranks; the first
    step's gradient as ``assert_gradients_close`` holds it.  The running
    statistics within ``stats_tol`` of one process's after the first and
    the last step, as ``assert_stats_close`` holds them (1e-4, as
    ``test_torch_train`` holds them against JAX: a running variance is
    E[x^2] - E[x]^2 and takes the sums' rounding magnified; 1.3e-5 measured
    on the incremental student's)."""
    (s0, s1), sf = [steps_of(g) for g in got], steps_of(ref)
    assert len(s0) == len(s1) == len(sf)
    for i, (a, b, want) in enumerate(zip(s0, s1, sf)):
        assert a["out"] == b["out"], i
        assert set(a["out"]) == set(want["out"])
        for key, value in want["out"].items():
            assert a["out"][key] == pytest.approx(value, rel=1e-5), (i, key)
        if want["segment_pseudo"] is not None:
            np.testing.assert_array_equal(
                interleave([a["segment_pseudo"], b["segment_pseudo"]]),
                want["segment_pseudo"])
        for coll in ("params", "batch_stats"):
            fa, fb = flatten_tree(a["state"][coll]), flatten_tree(b["state"][coll])
            for path in fa:
                np.testing.assert_array_equal(fa[path], fb[path], err_msg=path)
        if i in (0, len(sf) - 1):
            assert_stats_close(a["state"]["batch_stats"], want["state"]["batch_stats"],
                               stats_tol, f"batch_stats, step {i + 1}")
    print("first step's gradient, world 2 - world 1: worst tensor %.3e, whole %.3e"
          % assert_gradients_close(s0[0]["grads"], sf[0]["grads"], "gradients"))


def test_open_seg_steps_match_one_process(world2):
    """Three ``OpenSegTrainer`` steps of Seg26 + the PDF recognizer through
    ``run_step`` at world 2 against world 1: one frozen step, then two past
    ``start_epoch`` (score pass, host pseudo-labels with an item's seed
    following its place in the global batch, the pipelined step); and each
    batch's pseudo-labels from the start's weights, bit-equal.  The
    rate is small (1e-4) because two float32 trajectories of this network
    part by a factor of ~10 a step from the order of their sums; at 5e-4
    the third loss already differs by 2e-5."""
    got, ref = world2["open_seg"], reference("open_seg")
    for g in got:
        for coll in ("params", "batch_stats"):
            a, b = flatten_tree(g["start"][coll]), flatten_tree(ref["start"][coll])
            for path in b:
                np.testing.assert_array_equal(a[path], b[path], err_msg=path)
    for i, want in enumerate(ref["masks"]):
        np.testing.assert_array_equal(interleave([g["masks"][i] for g in got]), want)
    assert sum(int(m.sum()) for m in ref["masks"]) > 0
    assert_steps_match(got, ref)
    flagged = [s["out"].get("pseudo_flagged", 0.0) for s in steps_of(ref)]
    assert flagged[0] == 0.0 and min(flagged[1:]) > 0.0, flagged
    assert "model" in steps_of(ref)[0]["grads"]


@pytest.fixture
def exact_knn():
    old, jgeo.FORCE_KNN_PATH = jgeo.FORCE_KNN_PATH, "exact"
    yield
    jgeo.FORCE_KNN_PATH = old


def test_open_seg_steps_match_jax(world2, exact_knn, tmp_path):
    """The same three steps at world 2 against the JAX ``OpenSegTrainer``
    on its 8-device mesh, on the same global batches (the pseudo-labels the
    port trained on) and weights, at ``test_torch_openseg.py``'s
    tolerances: each step's losses within 1e-4 relative; the first step's
    backbone gradient as ``assert_gradient_triple`` holds it (port and JAX
    each against the port's float64 gradient too: at this batch a tensor of
    the JAX gradient sits 0.27 of its max off the port's); parameters
    and running statistics within 1e-4 of each tensor's max after the first
    step and within 1e-2 after the third."""
    cfg = dict(copy.deepcopy(ranks.OPEN_CFG), save_path=str(tmp_path))
    jtrainer = JAX_TRAINERS.build(dict(type="OpenSegTrainer", cfg=JaxConfig(cfg)))
    record_gradients(jtrainer)
    # the state starts from the port's start (equal on every rank and in
    # one process, asserted above): no initialisation to compile
    start = reference("open_seg")["start"]
    jtrainer._init_variables = lambda batch, rng: (start["params"],
                                                   start["batch_stats"])
    first = ranks.scene_batch(21)
    jtrainer.initialize_state(jtrainer.device_batch(
        dict(first, segment_pseudo=first["segment"])))
    got = world2["open_seg"]
    batches = []
    for i, seed in enumerate((21, 22, 23)):
        batch = ranks.scene_batch(seed)
        batch["segment_pseudo"] = interleave([g["steps"][i]["segment_pseudo"]
                                              for g in got])
        batches.append(jtrainer.device_batch(batch))
    got = got[0]
    rec = build_recognizer(ranks.RECOGNIZER)
    for i, (epoch, jbatch, step) in enumerate(zip((0, 1, 1), batches, got["steps"])):
        jtrainer.state, jout = jtrainer._train_step(
            jtrainer.state, jbatch, jax.random.PRNGKey(i),
            jnp.asarray(rec.loss_weight(epoch), jnp.float32))
        for key in ("loss", "seg_loss", "loss_rec"):
            assert step["out"][key] == pytest.approx(float(jout[key]), rel=1e-4), (i, key)
        tol = 1e-4 if i == 0 else 1e-2
        if i == 0:
            assert_gradient_triple(step["grads"]["model"],
                                   recorded_gradients(jtrainer)["model"],
                                   reference("float64")["grads"], "open-set step 1")
        if i in (0, 2):
            assert_trees_close(step["state"]["params"], jtrainer.state.params, tol,
                               "params")
            assert_trees_close(step["state"]["batch_stats"], jtrainer.state.batch_stats,
                               tol, "batch_stats")


@pytest.mark.parametrize("key", ["ptv2", "incr"])
def test_ptv2_and_incr_steps_match_one_process(world2, key):
    """One PT-v2m2 ``DefaultTrainer`` step (AdamW, CE, drop path 0; one
    room a rank) and one ``IncrSegTrainer`` step (a frozen Seg26 teacher
    into a Seg26 student) at world 2 against world 1, as
    ``assert_steps_match`` holds them; the teacher stays equal on both
    ranks."""
    got, ref = world2[key], reference(key)
    assert_steps_match(got, ref)
    if key == "incr":
        for name, value in got[0][0]["teacher"].items():
            np.testing.assert_array_equal(value, got[1][0]["teacher"][name])
            np.testing.assert_array_equal(value, ref[0]["teacher"][name])


def test_float64_gradient_matches_one_process(world2):
    """The whole open-set backbone's loss and gradient in float64 at world
    2 against world 1: every tensor within 1e-9 of the largest gradient
    and the whole within 1e-9 in L2 (the float32 gradient of this network
    moves by percents with the order of its sums, so only float64 shows
    that the data-parallel sums are the one-process sums)."""
    got, ref = world2["float64"], reference("float64")
    ref_flat = flatten_tree(ref["grads"])
    scale = max(np.abs(v).max() for v in ref_flat.values())
    for g in got:
        assert g["loss"] == pytest.approx(ref["loss"], rel=1e-12)
        flat = flatten_tree(g["grads"])
        diff2 = sum(((flat[k] - v) ** 2).sum() for k, v in ref_flat.items())
        norm2 = sum((v ** 2).sum() for v in ref_flat.values())
        assert (diff2 / norm2) ** 0.5 < 1e-9
        for k, v in ref_flat.items():
            assert np.abs(flat[k] - v).max() <= 1e-9 * scale, k


def test_float64_pseudo_labels_after_an_update_match_one_process(world2):
    """The open-set steps of ``open_seg_float64`` (one update, then a step
    past ``start_epoch``) in float64 at world 2 against world 1: the
    running statistics after each step within 1e-10 of max(1, |stat|), and
    the pseudo-labels the second step trained on (the score pass on the
    updated weights, then the host graph stage with each item's seed from
    its place in the global batch) bit-equal.  In float32 on the card the
    running statistics part by ~1e-4 after an update (the order of the
    stats pass's sums) and the graph stage flips regions of the flagged
    points; in float64 the two layouts agree, so that order is the whole
    cause."""
    got, ref = world2["open_seg_float64"], reference("open_seg_float64")
    for g in got:
        assert len(g) == len(ref) == 2
        for i, (step, want) in enumerate(zip(g, ref)):
            assert_stats_close(step["stats"], want["stats"], 1e-10, f"step {i + 1}")
            assert step["out"]["loss"] == pytest.approx(want["out"]["loss"], rel=1e-12)
    pseudo = ref[1]["segment_pseudo"]
    np.testing.assert_array_equal(interleave([g[1]["segment_pseudo"] for g in got]), pseudo)
    assert (pseudo == 5).sum() > 0 and not (ref[0]["segment_pseudo"] == 5).any()
