"""Port parity of ``ssd_tpu_torch/parallel/`` against ``ssd_tpu/parallel/``
on the CPU: mesh shapes and errors, launch detection, the placement rules
over every leaf of a tiny tree and of tpu_scaled_large's, the loader's
shards; data-parallel serving and evaluation on two CPU "devices"; and,
in one 2-rank gloo group (``tests/torch_parallel_worker.py``),
``train_from_config`` with ``configs/tpu_scaled_large.yaml``'s
``parallel:`` block and with DP + FSDP, checkpoints moving between one
process and two ranks both ways."""

import copy
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssd_tpu.models.ssd_model import build_model as jax_build_model
from ssd_tpu.parallel import mesh as jmesh
from ssd_tpu.parallel.partition import param_pspec
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.evaluation import evaluate as teval
from ssd_tpu_torch.models.conformer import init_flax_style
from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.parallel import mesh as tmesh
from ssd_tpu_torch.parallel.partition import Placement, param_placement
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.training import train as ttrain
from ssd_tpu_torch.training.checkpoint import load_checkpoint
from ssd_tpu_torch.utils.config import load_config

from .test_torch_data import _assert_same_batches, _loaders, _rows
from .test_torch_training import NOISE_ONLY, _cfg, _corpus
from .torch_parallel_worker import run_group
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("n,data,model", [
    (8, None, 1), (8, None, 2), (8, 4, 2), (8, 3, 2), (2, None, 2), (1, None, 2), (4, None, 3),
    (1, "auto", 1), (4, 2, 1),
])
def test_mesh_shape_and_errors_match_make_mesh(n, data, model):
    cfg = {"parallel": {"data": data, "model": model}}
    try:
        want = jmesh.mesh_from_config(cfg, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.mesh_shape_from_config(cfg, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.mesh_shape_from_config(cfg, n) == (want.shape["data"], want.shape["model"])
    if n == 1:  # one process without a group: the same checks, no mesh
        assert tmesh.mesh_from_config(cfg, world=1) is None


JAX_ENVS = [
    {}, {"TPU_WORKER_HOSTNAMES": "host0"}, {"SLURM_NTASKS": "1", "OMPI_COMM_WORLD_SIZE": "bogus"},
    {"COORDINATOR_ADDRESS": "10.0.0.1:1234"}, {"JAX_COORDINATOR_ADDRESS": "10.0.0.1:1234"},
    {"MEGASCALE_COORDINATOR_ADDRESS": "10.0.0.1:1234"}, {"TPU_WORKER_HOSTNAMES": "host0,host1"},
    {"SLURM_NTASKS": "4"}, {"OMPI_COMM_WORLD_SIZE": "2"}, {"WORLD_SIZE": "2"},
]


# the TPU runtime's own markers: no CUDA launch sets them, the port reads none
TPU_ONLY = {"TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"}


@pytest.mark.parametrize("env", JAX_ENVS, ids=lambda e: ",".join(e) or "empty")
def test_launch_detection_matches_jax(env):
    """The JAX package's answer on every env, except that the TPU runtime's
    markers alone are no launch for the port."""
    want = jmesh.multihost_launch_detected(env) and not (env and set(env) <= TPU_ONLY)
    assert tmesh.multihost_launch_detected(env) == want


def test_launch_initialization_joins_or_raises(monkeypatch):
    """torchrun's variables (at any world size, 1 included) and the JAX
    package's explicit contract start a group, gloo on the CPU; a failed
    ``init_process_group`` raises (the JAX package warns and goes on);
    ``WORLD_SIZE=2`` without a launcher's ``RANK`` raises."""
    calls = []
    # the env:// rendezvous copies these into os.environ: restored after the test
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29555")
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda: "gloo")
    assert tmesh.maybe_initialize_distributed({}, device="cpu") is False
    torchrun = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1",
                "MASTER_ADDR": "localhost", "MASTER_PORT": "29555"}
    assert tmesh.maybe_initialize_distributed(torchrun, device="cpu") is True
    assert calls[-1] == dict(backend="gloo", init_method="env://", rank=0, world_size=1)
    jax_style = {"COORDINATOR_ADDRESS": "10.0.0.1:9999", "NUM_PROCESSES": "2", "PROCESS_ID": "1"}
    tmesh.maybe_initialize_distributed(jax_style, device="cpu")
    assert calls[-1] == dict(backend="gloo", init_method="tcp://10.0.0.1:9999", rank=1,
                             world_size=2)
    with pytest.raises(RuntimeError, match="rank, world size or rendezvous"):
        tmesh.maybe_initialize_distributed({"SLURM_NTASKS": "4"}, device="cpu")
    with pytest.raises(RuntimeError, match="no launcher set RANK"):
        tmesh.maybe_initialize_distributed({"WORLD_SIZE": "2"}, device="cpu")

    def refuse(**kw):
        raise RuntimeError("connection refused")

    monkeypatch.setattr(tmesh.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="connection refused"):
        tmesh.maybe_initialize_distributed(torchrun, device="cpu")


def test_row_split_pads_and_weights_an_uneven_node_batch():
    split = [tmesh.RowSplit(local_data=2, local_index=r) for r in range(2)]
    arrays = {"emg": np.arange(5 * 3, dtype=np.float32).reshape(5, 3),
              "emg_lengths": np.arange(1, 6, dtype=np.int32), "weight": np.ones(5, np.float32)}
    a, b = (s.take(arrays, 5) for s in split)
    assert a["emg"].shape == b["emg"].shape == (3, 3)
    np.testing.assert_array_equal(np.concatenate([a["emg"], b["emg"]])[:5], arrays["emg"])
    assert b["weight"].tolist() == [1, 1, 0] and b["emg_lengths"][-1] == 0
    np.testing.assert_array_equal(tmesh.pad_batch_to_multiple(arrays, 4)[0]["emg"],
                                  jmesh.pad_batch_to_multiple(arrays, 4)[0]["emg"])


# ---------------------------------------------------------------- placement


def _port_name(path):
    """A JAX leaf path → the port's ``state_dict`` key."""
    names = [str(getattr(p, "key", p)) for p in path]
    out = []
    for n in names:
        if n.startswith("block_"):
            out += ["blocks", n[len("block_"):]]
        elif n.startswith("conv_") and "subsample" in names:
            out += ["convs", n]
        else:
            out.append({"kernel": "weight", "scale": "weight"}.get(n, n))
    return ".".join(out)


def _to_port_dims(name, ndim):
    """JAX leaf dim → port dim, by the bridge's layouts."""
    if name.endswith(("query.weight", "key.weight", "value.weight")):
        return (1, 0, 0)
    if name.endswith(("query.bias", "key.bias", "value.bias")):
        return (0, 0)
    if name.endswith("mha.out.weight"):
        return (1, 1, 0)
    if ndim == 2:
        return (1, 0)
    if ndim == 3:
        return (2, 1, 0)
    return tuple(range(ndim))


def _leaves(cfg, input_dim):
    """(params, batch_stats) leaves of the JAX model, shapes only."""
    model = jax_build_model(cfg, input_dim=input_dim, vocab_size=48)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, input_dim)), jnp.array([64]), train=False))
    out = []
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(coll, {}))[0]:
            out.append((coll, path, leaf))
    return out


@pytest.mark.parametrize("tree", ["tiny", "tpu_scaled_large"])
def test_param_placement_matches_param_pspec_on_every_leaf(tree):
    if tree == "tiny":
        cfg, input_dim = _cfg(), 16
    else:
        # the port's unrolled layout (scan_layers stacks the blocks in JAX,
        # which changes which small leaves FSDP takes)
        cfg = load_config(REPO / "configs" / "tpu_scaled_large.yaml")
        cfg["model"]["encoder"]["scan_layers"] = False
        input_dim = 8 * 80
    heads = cfg["model"]["encoder"]["num_heads"]
    port_names = {n for n, _ in build_model(cfg, input_dim, 48).state_dict().items()} \
        if tree == "tiny" else None
    leaves = _leaves(cfg, input_dim)
    seen = set()
    for model_par, fsdp_data in ((1, 0), (2, 0), (1, 4), (2, 2), (2, 4), (4, 32)):
        for coll, path, leaf in leaves:
            name = _port_name(path)
            seen.add(name)
            if coll == "batch_stats":
                path = (jax.tree_util.DictKey("batch_stats"),) + tuple(path)
            spec = list(param_pspec(path, leaf, fsdp_data=fsdp_data))
            spec += [None] * (len(leaf.shape) - len(spec))
            dims = _to_port_dims(name, len(leaf.shape))
            want = Placement(
                tp=next((dims[d] for d, s in enumerate(spec) if s == "model"), None)
                if model_par > 1 else None,
                fsdp=next((dims[d] for d, s in enumerate(spec) if s == "data"), None),
            )
            # the port's shape: JAX dims that land on one port dim multiply
            port_shape = [1] * (max(dims) + 1 if dims else 0)
            for d, k in enumerate(dims):
                port_shape[k] *= leaf.shape[d]
            got = param_placement(name, port_shape, model_par, fsdp_data, heads,
                                  buffer=coll == "batch_stats")
            assert got == want, (name, model_par, fsdp_data, spec)
    if port_names is not None:
        assert seen == port_names  # every leaf, and the bridge's names
    assert any("ffn1.w1" in n for n in seen) and any("mha.query" in n for n in seen)


# ---------------------------------------------------------------- loader


@pytest.mark.parametrize("raw", [False, True])
def test_loader_shards_bit_equal_to_jax_with_an_empty_shard(tmp_path, raw):
    _rows(tmp_path)
    seen = []
    for shard in range(2):
        jl, tl = _loaders(tmp_path, raw=raw, num_shards=2, shard_index=shard,
                          **({"raw_hop_length": 10} if raw else {}))
        tl.batch_size = jl.batch_size = 3  # 8 rows: global batches of 6 and 2
        _assert_same_batches(jl, tl, epochs=2)
        seen.append([b.utterance_ids for b in tl])
    assert any(ids == [] for ids in seen[1])  # shard 1's last batch: all padding
    assert len(seen[0]) == len(seen[1]) == 2


# ---------------------------------------------------------------- inference


def _serving_cfg():
    return {"data": {"vocab": "unused"},
            "features": {"emg": {"sample_rate": 1000, "n_fft": 64, "hop_length": 16,
                                 "n_mels": 8, "normalize": "per_file"}},
            "model": {"encoder": {"d_model": 32, "num_layers": 2, "num_heads": 4, "ffn_dim": 64,
                                  "depthwise_conv_kernel_size": 5, "subsample_factor": 2,
                                  "dropout": 0.0, "input_dim": 4 * 8},
                      "projection_dim": 16},
            "decoding": {"token_top_k": 8}}


def test_data_parallel_engine_on_two_cpu_devices_equals_one(monkeypatch):
    monkeypatch.setattr(teng, "SAMPLE_BUCKET", 640)
    cfg = _serving_cfg()
    model = build_model(cfg, 32, default_vocab().size)
    init_flax_style(model, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    one = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu")
    two = teng.InferenceEngine(cfg, sd, default_vocab(), device="cpu", data_parallel=True,
                               devices=["cpu", "cpu"])
    assert len(two.replicas.models) == 2
    rng = np.random.default_rng(0)
    reqs = [rng.normal(size=(n, 4)).astype(np.float32) for n in (900, 1500, 400)]
    (lp1, ol1), (lp2, ol2) = one.forward(reqs), two.forward(reqs)
    assert lp1.shape == lp2.shape and torch.equal(ol1, ol2)
    torch.testing.assert_close(lp2, lp1, atol=1e-5, rtol=1e-5)
    assert one.transcribe(reqs) == two.transcribe(reqs)


# ---------------------------------------------------------------- 2 ranks


def _flat(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["model"]["encoder"]["dropout"] = cfg["model"]["ctc_dropout"] = 0.0
    cfg["augmentation"] = {}
    return cfg


def _close(got_dir, want_dir, atol=5e-5, stat_atol=5e-4):
    got, want = load_checkpoint(got_dir), load_checkpoint(want_dir)
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"])
    assert got["optimizer"]["update_count"] == want["optimizer"]["update_count"]
    for k, w in want["state_dict"].items():
        if k.endswith(NOISE_ONLY):
            continue
        tol = stat_atol if k.endswith(".bn.mean") else atol
        np.testing.assert_allclose(got["state_dict"][k].numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=k)
    for i, st in want["optimizer"]["adamw"]["state"].items():
        assert st["exp_avg"].shape == got["optimizer"]["adamw"]["state"][i]["exp_avg"].shape


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One process trains an epoch; two ranks resume it with
    tpu_scaled_large's ``parallel:`` block for epoch 2, train an epoch
    from scratch with DP + FSDP, and train one with that block while rank 1
    alone is signalled late, then resume it; one process does the same
    steps alone."""
    root = tmp_path_factory.mktemp("par")
    cfg = _flat(json.loads(_corpus(root).read_text()))
    ttrain.train_from_config(cfg, root / "one", device="cpu")
    for d in ("ranks", "alone"):
        shutil.copytree(root / "one", root / d)
    large = load_config(REPO / "configs" / "tpu_scaled_large.yaml")["parallel"]
    resumed = dict(cfg, parallel=large, optim=dict(cfg["optim"], max_epochs=2))
    jobs = [dict(name="resume", kind="train", cfg=resumed, run_dir=str(root / "ranks"),
                 resume=True),
            dict(name="dp_fsdp", kind="train", cfg=dict(cfg, parallel={"fsdp": True}),
                 run_dir=str(root / "dp_fsdp")),
            dict(name="preempt", kind="preempt", cfg=dict(cfg, parallel=large),
                 run_dir=str(root / "preempt"), signalled=1),
            dict(name="preempt_resume", kind="train", cfg=dict(cfg, parallel=large),
                 run_dir=str(root / "preempt"), resume=True)]
    ranks = run_group(jobs, root / "group")
    ttrain.train_from_config(dict(cfg, optim=dict(cfg["optim"], max_epochs=2)), root / "alone",
                             resume=True, device="cpu")
    return root, cfg, large, ranks


def test_tpu_scaled_large_parallel_block_resumes_a_one_process_checkpoint_at_two_ranks(two_ranks):
    root, _, large, ranks = two_ranks
    assert large == {"data": "auto", "model": 2, "sequence": True, "fsdp": True}
    summary = ranks[0]["resume"]
    assert [h["epoch"] for h in summary["history"]] == [2]
    assert ranks[1]["resume"]["history"][0]["val"] == summary["history"][0]["val"]
    saved = json.loads((root / "ranks" / "config.json").read_text())
    assert saved["model"]["encoder"]["sequence_parallel"] is True
    # the two-rank epoch equals the one-process epoch, and its checkpoint
    # (written by rank 0, full tensors) loads in one process
    _close(root / "ranks" / "last", root / "alone" / "last")


def test_two_rank_checkpoint_resumes_in_one_process(two_ranks):
    root, cfg, _, _ = two_ranks
    summary = ttrain.train_from_config(dict(cfg, optim=dict(cfg["optim"], max_epochs=3)),
                                       root / "ranks", resume=True, device="cpu")
    assert [h["epoch"] for h in summary["history"]] == [3]
    assert np.isfinite(summary["history"][0]["val"]["total"])


def test_dp_fsdp_epoch_equals_one_process(two_ranks):
    root, _, _, ranks = two_ranks
    assert ranks[0]["dp_fsdp"]["history"][0]["train"]["batches"] == 2
    _close(root / "dp_fsdp" / "last", root / "one" / "last")


def test_a_signal_on_one_rank_stops_every_rank_at_one_resumable_last(two_ranks):
    """Rank 1 is signalled after the epoch's in-epoch agreement: the ranks
    agree again after the epoch, both save the same `last` (the completed
    epoch 0, the 2 steps taken) and stop; the next run resumes it."""
    _, _, _, ranks = two_ranks
    for r in ranks:
        assert r["preempt"]["preempted"] is True
        assert r["preempt"]["history"] == []
        assert r["preempt"]["last"] == (0, 2, 2)
    resumed = [r["preempt_resume"] for r in ranks]
    assert [h["epoch"] for h in resumed[0]["history"]] == [1]
    assert resumed[0]["preempted"] is False
    assert resumed[1]["history"][0]["val"] == resumed[0]["history"][0]["val"]
    assert np.isfinite(resumed[0]["history"][0]["val"]["total"])


def test_data_parallel_eval_on_two_cpu_devices_equals_one(two_ranks, tmp_path):
    root, _, _, _ = two_ranks
    vocab = default_vocab()
    runs = {}
    for dp in (False, True):
        cfg = json.loads((root / "one" / "config.json").read_text())
        runs[dp] = teval.evaluate_checkpoint(
            root / "one" / "last", cfg, vocab, ["voiced"], ["train", "val"],
            lambda lp, ol: [str(x) for x in lp.argmax(-1)[:, :3].tolist()], batch_size=3,
            data_parallel=dp, device="cpu", devices=["cpu", "cpu"])
    assert runs[True]["records"] == runs[False]["records"]
    assert len(runs[True]["records"]) == 5
