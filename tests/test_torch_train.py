"""Port vs reference: the training path on the CPU.

``loss_fn`` and its gradients, ``cfg.remat``, AdamW and the schedules, int8
gradient compression, the data pipeline, checkpoints in the reference's
layout, and ``launch.train.train`` against the reference driven step by
step.  The reference runs OUTSIDE any mesh (its ``train()`` enters a mesh,
which raises under the installed jax); parameters come from its
``init_params`` through ``params_from_numpy``; batches from numpy seeds.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro import configs as ref_configs
from repro.data import pipeline as ref_data
from repro.launch import steps as ref_steps
from repro.models import model as ref_model
from repro.optim import compression as ref_comp
from repro.optim import optimizer as ref_opt
from repro_torch import checkpoint as port_ckpt
from repro_torch import configs as port_configs
from repro_torch.data import pipeline as port_data
from repro_torch.launch import steps as port_steps
from repro_torch.launch import train as port_train
from repro_torch.models import model as port_model
from repro_torch.optim import compression as port_comp
from repro_torch.optim import optimizer as port_opt

LOSS_RTOL = 1e-5      # float32 loss, sums re-associated
GRAD_TOL = 1e-4       # per leaf, relative to the leaf's largest gradient
OPT_TOL = 1e-6        # AdamW over 3 steps (the reference's own arithmetic)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _walk(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(x).astype(np.float64)


def _assert_trees_close(port_tree, ref_tree, tol, rel=False):
    ref_leaves = dict(_walk(_np_tree(ref_tree)))
    port_leaves = dict(_walk(port_tree))
    assert ref_leaves.keys() == port_leaves.keys()
    for path, r in ref_leaves.items():
        r, p = _as_np(r), _as_np(port_leaves[path])
        bound = tol * max(float(np.abs(r).max()), 1e-30) if rel else tol
        err = float(np.abs(p - r).max()) if r.size else 0.0
        assert err <= bound, f"{'/'.join(path)}: {err} > {bound}"


@pytest.fixture(scope="module")
def smoke():
    ref_cfg = ref_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    port_cfg = port_configs.get_smoke_config("llama3-8b").replace(
        compute_dtype="float32")
    ref_params = ref_model.init_params(ref_cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, ref_cfg.vocab_size, (2, 24)).astype(np.int32)
    targets = rng.integers(0, ref_cfg.vocab_size, (2, 24)).astype(np.int32)
    return ref_cfg, port_cfg, ref_params, tokens, targets


def _port_params(ref_params):
    return port_steps._trainable(
        port_model.params_from_numpy(_np_tree(ref_params), device="cpu"))


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference(smoke):
    ref_cfg, port_cfg, ref_params, tokens, targets = smoke
    (ref_loss, ref_parts), ref_grads = jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, ref_cfg, jnp.asarray(tokens),
                                    jnp.asarray(targets)), has_aux=True)(ref_params)
    batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    loss, parts, grads = port_steps.loss_and_grads(
        port_cfg, _port_params(ref_params), batch)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["nll"]), float(ref_parts["nll"]),
                               rtol=LOSS_RTOL)
    assert float(parts["aux"]) == float(ref_parts["aux"]) == 0.0
    _assert_trees_close(grads, ref_grads, GRAD_TOL, rel=True)


def test_loss_fn_forms_logsumexp_minus_gold(smoke):
    _, port_cfg, ref_params, tokens, targets = smoke
    params = port_model.params_from_numpy(_np_tree(ref_params), device="cpu")
    with torch.no_grad():
        loss, parts = port_model.loss_fn(params, port_cfg, torch.from_numpy(tokens),
                                         torch.from_numpy(targets), aux_weight=0.5)
        logits, _ = port_model.forward(params, port_cfg, torch.from_numpy(tokens))
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), torch.from_numpy(targets).long().reshape(-1))
    np.testing.assert_allclose(float(parts["nll"]), float(want), rtol=1e-6)
    assert float(loss) == float(parts["nll"])            # aux is 0 for dense


def test_remat_gives_identical_gradients(smoke):
    _, port_cfg, ref_params, tokens, targets = smoke
    batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    out = {}
    for remat in (False, True):
        cfg = port_cfg.replace(remat=remat)
        out[remat] = port_steps.loss_and_grads(cfg, _port_params(ref_params), batch)
    assert torch.equal(out[False][0], out[True][0])
    for (path, a), (_, b) in zip(_walk(out[False][2]), _walk(out[True][2])):
        assert torch.equal(a, b), "/".join(path)


def test_remat_recomputes_the_layer_forward(smoke, monkeypatch):
    _, port_cfg, ref_params, tokens, targets = smoke
    from repro_torch.models import blocks
    calls = []
    real = blocks._transformer_block
    monkeypatch.setattr(blocks, "_transformer_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = {"tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    for remat, want in ((False, 2), (True, 4)):
        calls.clear()
        port_steps.loss_and_grads(port_cfg.replace(remat=remat),
                                  _port_params(ref_params), batch)
        assert len(calls) == want       # 2 layers, each run again in backward
    calls.clear()
    with torch.no_grad():               # no gradients recorded: no checkpoint
        port_model.forward(_port_params(ref_params), port_cfg.replace(remat=True),
                           torch.from_numpy(tokens))
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# optimizer, schedules, compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("opt_kw", [
    {}, {"clip_norm": None}, {"compress_grads": True},
    {"state_dtype": "bfloat16", "clip_norm": 0.05}], ids=str)
def test_adamw_three_steps_match_reference(opt_kw):
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32),
              "blk": {"u": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        for _ in range(3)]
    ref_cfg = ref_opt.AdamWConfig(**opt_kw)
    port_cfg = port_opt.AdamWConfig(**opt_kw)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    ref_state = ref_opt.adamw_init(ref_p, ref_cfg)
    port_p = port_model.params_from_numpy(params, device="cpu")
    port_state = port_opt.adamw_init(port_p, port_cfg)
    sched_ref = ref_opt.cosine_schedule(1e-2, 1, 3)
    sched_port = port_opt.cosine_schedule(1e-2, 1, 3)
    for step, g in enumerate(grads):
        lr_ref, lr_port = sched_ref(step), sched_port(port_state.step)
        ref_p, ref_state, ref_m = ref_opt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), ref_state, ref_p, ref_cfg, lr_ref)
        port_p, port_state, port_m = port_opt.adamw_update(
            port_model.params_from_numpy(g, device="cpu"), port_state, port_p,
            port_cfg, lr_port)
        np.testing.assert_allclose(float(port_m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=OPT_TOL)
    assert int(port_state.step) == int(ref_state.step) == 3
    _assert_trees_close(port_p, ref_p, OPT_TOL)
    m_tol = 1e-2 if opt_kw.get("state_dtype") == "bfloat16" else OPT_TOL
    _assert_trees_close(port_state.m, ref_state.m, m_tol, rel=True)
    _assert_trees_close(port_state.v, ref_state.v, m_tol, rel=True)
    if port_state.ef is not None:
        _assert_trees_close(port_state.ef, ref_state.ef, OPT_TOL)


@pytest.mark.parametrize("name,args", [
    ("cosine_schedule", (3e-4, 20, 100)), ("cosine_schedule", (1e-3, 0, 10)),
    ("linear_schedule", (3e-4, 20, 100)), ("constant_schedule", (3e-4,))])
def test_schedules_equal_reference(name, args):
    ref_f, port_f = getattr(ref_opt, name)(*args), getattr(port_opt, name)(*args)
    for step in (0, 1, 5, 19, 20, 21, 50, 99, 100, 150):
        want = float(ref_f(jnp.int32(step)))
        got = port_f(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=2e-7, atol=0)


def test_compress_with_error_feedback_equals_reference():
    rng = np.random.default_rng(6)
    grads = {"a": rng.standard_normal((7, 9)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((11,)).astype(np.float32) * 1e-3,
                   "z": np.zeros((4,), np.float32)}}
    ef = jax.tree_util.tree_map(
        lambda g: (rng.standard_normal(g.shape) * 1e-2).astype(np.float32), grads)
    ref_g, ref_ef = ref_comp.compress_with_error_feedback(
        jax.tree_util.tree_map(jnp.asarray, grads),
        jax.tree_util.tree_map(jnp.asarray, ef))
    port_g, port_ef = port_comp.compress_with_error_feedback(
        port_model.params_from_numpy(grads, device="cpu"),
        port_model.params_from_numpy(ef, device="cpu"))
    _assert_trees_close(port_g, ref_g, 0.0)
    _assert_trees_close(port_ef, ref_ef, 0.0)
    codes, scale = port_comp.quantize_int8(torch.from_numpy(grads["a"]))
    ref_codes, ref_scale = ref_comp.quantize_int8(jnp.asarray(grads["a"]))
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    assert float(scale) == float(ref_scale)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"batch_size": 3, "seq_len": 17, "vocab_size": 50, "seed": 1},
    {"batch_size": 2, "seq_len": 9, "vocab_size": 1000, "seed": 7,
     "host_index": 1, "host_count": 2, "embed_dim": 4}], ids=str)
def test_synthetic_batches_equal_reference(kw):
    ref_it = iter(ref_data.SyntheticLM(ref_data.DataConfig(**kw)))
    port_it = iter(port_data.make_pipeline(port_data.DataConfig(**kw)))
    for _ in range(3):
        want, got = next(ref_it), next(port_it)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_token_file_batches_equal_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.arange(1000, dtype=np.int32).tofile(path)
    kw = dict(batch_size=4, seq_len=15, vocab_size=1000, seed=3, path=str(path),
              host_index=1, host_count=2)
    ref_it = iter(ref_data.TokenFile(ref_data.DataConfig(**kw)))
    port_it = iter(port_data.make_pipeline(port_data.DataConfig(**kw)))
    for _ in range(20):    # wraps around the host's share
        want, got = next(ref_it), next(port_it)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetcher_surfaces_source_errors():
    def broken():
        yield {"x": 1}
        raise OSError("disk gone")
    it = port_data.Prefetcher(broken())
    assert next(it) == {"x": 1}
    with pytest.raises(OSError):
        next(it)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ref_state(ref_params, **opt_kw):
    cfg = ref_opt.AdamWConfig(**opt_kw)
    return ref_steps.TrainState(params=ref_params,
                                opt=ref_opt.adamw_init(ref_params, cfg),
                                step=jnp.int32(5))


def _port_state(ref_params, **opt_kw):
    return port_steps.init_train_state(
        port_configs.get_smoke_config("llama3-8b"),
        port_opt.AdamWConfig(**opt_kw), device="cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_reference_checkpoint_restores_leaf_for_leaf(smoke, tmp_path, compress):
    _, _, ref_params, _, _ = smoke
    state = _ref_state(ref_params, compress_grads=compress)
    # non-zero moments so that m and v cannot be mixed up
    state = dataclasses.replace(state, opt=ref_opt.OptState(
        step=jnp.int32(5),
        m=jax.tree_util.tree_map(lambda p: p * 2.0, ref_params),
        v=jax.tree_util.tree_map(lambda p: p * p, ref_params),
        ef=state.opt.ef))
    ref_ckpt.save(str(tmp_path), 5, state, extras={"loss": 1.5})
    target = _port_state(ref_params, compress_grads=compress)
    got, step, extras = port_ckpt.restore(str(tmp_path), target, device="cpu")
    assert step == 5 and extras == {"loss": 1.5}
    assert int(got.step) == 5 and int(got.opt.step) == 5
    assert got.params["embed"].requires_grad
    _assert_trees_close(got.params, state.params, 0.0)
    _assert_trees_close(got.opt.m, state.opt.m, 0.0)
    _assert_trees_close(got.opt.v, state.opt.v, 0.0)
    if compress:
        _assert_trees_close(got.opt.ef, state.opt.ef, 0.0)
    # the port writes the same keys, files and leaf order as the reference
    port_dir = tmp_path / "port"
    port_ckpt.save(str(port_dir), 5, got, extras={"loss": 1.5})
    with open(tmp_path / "step_000000005" / "manifest.json") as f:
        ref_manifest = json.load(f)
    with open(port_dir / "step_000000005" / "manifest.json") as f:
        port_manifest = json.load(f)
    assert port_manifest == ref_manifest
    back, _, _ = ref_ckpt.restore(str(port_dir), state)
    _assert_trees_close(back.opt.v, state.opt.v, 0.0)


def test_train_state_from_numpy_carries_the_reference_state(smoke):
    _, _, ref_params, _, _ = smoke
    state = _ref_state(ref_params, compress_grads=True)
    got = port_steps.train_state_from_numpy(
        _np_tree(state.params), _np_tree(state.opt), device="cpu", step=state.step)
    assert int(got.step) == 5 and int(got.opt.step) == 0
    _assert_trees_close(got.params, state.params, 0.0)
    _assert_trees_close(got.opt.ef, state.opt.ef, 0.0)
    assert all(p.requires_grad for _, p in _walk(got.params))


def test_manager_keeps_k_and_ignores_incomplete(tmp_path):
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2, 2, dtype=torch.bfloat16)}}
    mgr = port_ckpt.CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree)
        tree["a"].add_(1.0)          # in place right after: the save is a snapshot
    mgr.wait()
    steps = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == ["step_000000002", "step_000000003"]
    os.makedirs(tmp_path / "step_000000009")          # no COMPLETE marker
    assert port_ckpt.latest_step(str(tmp_path)) == 3
    got, step, _ = mgr.restore_latest(tree)
    assert step == 3
    np.testing.assert_array_equal(got["a"].numpy(), [2.0, 3.0, 4.0, 5.0])
    assert got["b"]["c"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        port_ckpt.restore(str(tmp_path / "nothing"), tree)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

def test_train_matches_reference_step_by_step(smoke, tmp_path):
    """``train()`` on the CPU, 3 steps, resumed from the reference's own
    initial state (a reference checkpoint at step 0): losses within 1e-4 of
    the reference's loss_fn + adamw_update driven by hand."""
    ref_cfg, port_cfg, ref_params, _, _ = smoke
    loop = port_train.TrainLoopConfig(steps=3, log_every=1, ckpt_dir=str(tmp_path),
                                      batch=2, seq=16, warmup=1, seed=3)
    opt_cfg = ref_opt.AdamWConfig(lr=loop.lr)
    state = ref_steps.TrainState(params=ref_params,
                                 opt=ref_opt.adamw_init(ref_params, opt_cfg),
                                 step=jnp.int32(0))
    ref_ckpt.save(str(tmp_path), 0, state)
    sched = ref_opt.cosine_schedule(loop.lr, loop.warmup, loop.steps)
    data = iter(ref_data.SyntheticLM(ref_data.DataConfig(
        batch_size=loop.batch, seq_len=loop.seq + 1,
        vocab_size=ref_cfg.vocab_size, seed=loop.seed)))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, y: ref_model.loss_fn(p, ref_cfg, t, y), has_aux=True))
    ref_losses = []
    params, opt = ref_params, state.opt
    for i in range(loop.steps):
        batch = next(data)
        (loss, _), grads = grad_fn(params, jnp.asarray(batch["tokens"]),
                                   jnp.asarray(batch["targets"]))
        params, opt, _ = ref_opt.adamw_update(grads, opt, params, opt_cfg, sched(i))
        ref_losses.append(float(loss))

    got_state, history, watchdog = port_train.train(port_cfg, loop, device="cpu")
    assert [s for s, _ in history] == [1, 2, 3]
    losses = [m["loss"] for _, m in history]
    np.testing.assert_allclose(losses, ref_losses, rtol=0, atol=1e-4)
    assert all(m["step_s"] > 0 for _, m in history)
    assert int(got_state.step) == 3 and port_ckpt.latest_step(str(tmp_path)) == 3
    _assert_trees_close(got_state.params, params, 1e-4)


def test_train_resumes_and_retries(tmp_path):
    cfg = port_configs.get_smoke_config("llama3-8b")
    loop = port_train.TrainLoopConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                                      batch=2, seq=8, log_every=1,
                                      inject_failures=0.3)
    state, history, _ = port_train.train(cfg, loop, device="cpu")
    assert [s for s, _ in history] == [1, 2, 3, 4]
    assert all(np.isfinite(m["loss"]) for _, m in history)
    assert port_ckpt.latest_step(str(tmp_path)) == 4
    # a second run finds step 4 complete and has nothing left to do
    _, again, _ = port_train.train(cfg, loop, device="cpu")
    assert again == []


def _smoke_loop(**kw):
    return port_train.TrainLoopConfig(steps=3, batch=2, seq=8, log_every=1, **kw)


def test_a_retried_gradient_computation_leaves_the_result_unchanged(monkeypatch):
    """A failure after the backward pass of step 2 is retried; the run ends
    with the same losses and parameters as one without the failure."""
    cfg = port_configs.get_smoke_config("llama3-8b")
    clean_state, clean_history, _ = port_train.train(cfg, _smoke_loop(), device="cpu")

    real, calls = port_steps.loss_and_grads, []

    def fails_once(*args):
        out = real(*args)
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected failure after the backward pass")
        return out

    monkeypatch.setattr(port_steps, "loss_and_grads", fails_once)
    state, history, _ = port_train.train(cfg, _smoke_loop(), device="cpu")
    assert len(calls) == 4                      # step 2 ran its gradients twice
    drop_time = lambda hist: [(s, {k: v for k, v in m.items() if k != "step_s"})
                              for s, m in hist]
    assert drop_time(history) == drop_time(clean_history)
    for (path, p), (_, q) in zip(_walk(state.params), _walk(clean_state.params)):
        assert torch.equal(p, q), "/".join(path)


def test_a_failure_mid_update_is_not_retried(monkeypatch, tmp_path):
    """A failure inside AdamW after the first leaf has been updated ends the
    run at once (retrying would apply that leaf's update twice); the next run
    resumes from the last complete checkpoint."""
    cfg = port_configs.get_smoke_config("llama3-8b")
    loop = _smoke_loop(ckpt_dir=str(tmp_path), ckpt_every=1)
    real_map, updates = port_opt._map, []

    def map_failing_on_step_2(fn, tree, *rest):
        if fn.__name__ != "upd":
            return real_map(fn, tree, *rest)
        updates.append(1)
        leaves = []

        def upd_or_fail(*a):
            if len(updates) == 2 and leaves:
                raise RuntimeError("injected failure mid-update")
            leaves.append(1)
            return fn(*a)
        return real_map(upd_or_fail, tree, *rest)

    monkeypatch.setattr(port_opt, "_map", map_failing_on_step_2)
    with pytest.raises(RuntimeError, match="mid-update"):
        port_train.train(cfg, loop, device="cpu")
    assert len(updates) == 2                    # step 2's update entered once
    assert port_ckpt.latest_step(str(tmp_path)) == 1

    monkeypatch.setattr(port_opt, "_map", real_map)
    state, history, _ = port_train.train(cfg, loop, device="cpu")
    assert [s for s, _ in history] == [2, 3]
    assert int(state.step) == 3 and port_ckpt.latest_step(str(tmp_path)) == 3


def test_cli_trains_and_refuses_meshes(capsys):
    assert port_train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                            "8", "--device", "cpu"]) == 0
    assert "loss" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="256 positions and the world has 1 rank"):
        port_train.main(["--smoke", "--mesh", "pod", "--device", "cpu"])


def test_train_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.train(port_configs.get_smoke_config("llama3-8b"),
                         port_train.TrainLoopConfig(steps=1))
