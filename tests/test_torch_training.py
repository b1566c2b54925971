"""ray_tpu_torch training against the JAX package on the CPU.

- ``forward`` and ``loss_fn`` on converted ``debug`` weights, in f32 and
  (via ``dataclasses.replace``) bf16;
- the learning-rate schedule against optax, steps 0..N;
- 5 steps of ``make_train_step`` against the JAX ``make_train_step`` on a
  1-device mesh built as ``bench.py:78-88`` builds it, from the same
  converted initial state and the same numpy batch: losses, accuracy,
  grad norms and final parameters;
- a run carried on from ``train_state_from_jax`` after 2 JAX steps, then 2
  steps in each package;
- ``remat_policy="dots"`` (Llama and MoE): loss and gradients equal to
  "nothing"'s bit for bit and to the JAX package's "dots" at the f32
  tolerances below, and, counted at the dispatcher, a backward that
  recomputes no ``aten.mm``.

Tolerances: f32 logits 1e-4 absolute and losses 1e-5 relative (the same
f32 math, summed in another order). Parameters after the steps: the
whole update (final minus initial parameters) to 1e-4 relative in norm,
and each element to 5e-5 absolute: Adam normalises each element's step to
about the learning rate (1e-3 here) whatever the gradient's size, so an
element whose gradient is near its rounding error moves by an amount
that rounding decides; 5e-5 is 5% of one step. bf16 logits 0.06 absolute and loss
1e-2 relative: the frameworks round bf16 activations at different points
(see tests/test_torch_models.py).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import llama as jllama
from ray_tpu.models import training as jtraining
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.parallel.sharding import ShardingRules, set_mesh
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import training as ttraining
from ray_tpu_torch.models.convert import params_from_jax, train_state_from_jax

from _torch_isolation import _module_isolation_guard  # noqa: F401

STEPS = 5
OPT = dict(learning_rate=1e-3, warmup_steps=2, decay_steps=20)


def _configs(dtype):
    jc, tc = jllama.CONFIGS["debug"], tllama.CONFIGS["debug"]
    if dtype == "bf16":
        jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    return jc, tc


def _batch(seed=0, b=4, s=32, with_mask=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32)}
    if with_mask:
        batch["mask"] = (rng.random((b, s)) < 0.8).astype(np.int32)
    return batch


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_and_loss_match_jax(dtype):
    jc, tc = _configs(dtype)
    jp = jllama.init_params(jc, jax.random.key(0))
    tp = params_from_jax(_np_tree(jp))
    batch = _batch(with_mask=True)
    jlogits = jllama.forward(jp, jnp.asarray(batch["tokens"]), jc)
    jloss, jaux = jllama.loss_fn(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jc)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tlogits = tllama.forward(tp, tb["tokens"], tc)
        tloss, taux = tllama.loss_fn(tp, tb, tc)
    assert tlogits.dtype == torch.float32
    atol, rtol = (1e-4, 1e-5) if dtype == "f32" else (0.06, 1e-2)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=atol)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=rtol)
    assert taux["tokens"].item() == float(jaux["tokens"])
    if dtype == "f32":
        assert taux["accuracy"].item() == float(jaux["accuracy"])


def test_schedule_matches_optax():
    for kw in (OPT, dict(warmup_steps=1, decay_steps=1000),
               dict(warmup_steps=10, decay_steps=10)):
        jsched = jtraining.OptimizerConfig(**kw).schedule()
        tsched = ttraining.OptimizerConfig(**kw).schedule()
        for n in list(range(0, 25)) + [999, 1000, 5000]:
            assert tsched(n) == pytest.approx(float(jsched(n)), rel=1e-6,
                                              abs=1e-12), (kw, n)
    assert ttraining.OptimizerConfig(**OPT).schedule()(0) == 0.0


@pytest.fixture(scope="module")
def jax_run():
    """5 JAX train steps on ``debug`` (f32); the converted state before
    step 1 and after step 2, per-step metrics, and the parameters after
    steps 4 and 5."""
    cfg = jllama.CONFIGS["debug"]
    mesh = make_mesh(MeshConfig(dp=1, fsdp=-1), devices=jax.devices()[:1])
    rules = ShardingRules()
    opt = jtraining.OptimizerConfig(**OPT).make()
    batch = {"tokens": jnp.asarray(_batch(seed=3)["tokens"])}
    out = {"metrics": [], "params": {}}
    with set_mesh(mesh):
        state, _ = jtraining.init_train_state(
            lambda key: jllama.init_params(cfg, key),
            jllama.param_logical_axes(cfg), opt, mesh, rules,
            jax.random.key(0))
        step = jtraining.make_train_step(
            lambda p, b: jllama.loss_fn(p, b, cfg, rules), opt, mesh, rules)
        out["state0"] = train_state_from_jax(state)
        for i in range(1, STEPS + 1):
            state, m = step(state, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if i == 2:
                out["state2"] = train_state_from_jax(state)
            if i >= 4:
                out["params"][i] = _np_tree(state.params)
    return out


def _torch_steps(state, n):
    cfg = tllama.CONFIGS["debug"]
    opt = ttraining.OptimizerConfig(**OPT).make()
    step = ttraining.make_train_step(
        lambda p, b: tllama.loss_fn(p, b, cfg), opt)
    batch = {"tokens": torch.from_numpy(_batch(seed=3)["tokens"])}
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _flat(params):
    return np.concatenate([np.asarray(t.detach() if isinstance(
        t, torch.Tensor) else t).ravel()
        for t in ttraining.tree_leaves(params)])


def _assert_params_close(tparams, jparams, start):
    got, want, p0 = _flat(tparams), _flat(jparams), _flat(start)
    np.testing.assert_allclose(got, want, atol=5e-5)
    moved = np.linalg.norm(want - p0)
    assert moved > 0
    assert np.linalg.norm(got - want) <= 1e-4 * moved


def test_train_steps_match_jax(jax_run):
    start = _flat(jax_run["state0"].params)
    state, metrics = _torch_steps(jax_run["state0"], STEPS)
    assert state.step == STEPS
    for i, (t, j) in enumerate(zip(metrics, jax_run["metrics"])):
        assert t["lr_step"] == j["lr_step"] == i
        for k in ("loss", "grad_norm"):
            assert t[k] == pytest.approx(j[k], rel=1e-5), (i, k)
        assert t["accuracy"] == j["accuracy"]
        assert t["tokens"] == j["tokens"]
    # the first step's learning rate is 0: its loss repeats, then falls
    assert metrics[1]["loss"] == pytest.approx(metrics[0]["loss"], rel=1e-6)
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    _assert_params_close(state.params, jax_run["params"][STEPS], start)


def test_bench_run_on_cpu_and_1b_bench_config():
    """``bench.run`` trains (the first step's learning rate is 0, so the
    warm-up and the first timed step give the same loss, then it falls)
    and reports no device metric off the card; ``1b_bench`` is the JAX
    bench's configuration (``bench.py:307-311``) field for field."""
    from ray_tpu_torch import bench as tbench

    res = tbench.run("debug", batch=2, seq=32, steps=3, device="cpu")
    losses = res["losses"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    assert losses[-1] < losses[0]
    assert res["device"] == "cpu" and "mfu" not in res
    want = dataclasses.replace(jllama.CONFIGS["1b"], vocab_size=32000,
                               tie_embeddings=True, max_seq=2048,
                               attn_block=1024)
    got = tbench.CONFIGS["1b_bench"]
    for f in dataclasses.fields(want):
        if f.name != "dtype":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.dtype == torch.bfloat16
    assert got.flops_per_token(2048) == want.flops_per_token(2048)


def test_resume_from_jax_state(jax_run):
    start = jax_run["state2"]
    assert (start.step, start.opt_state.adam_count,
            start.opt_state.schedule_count) == (2, 2, 2)
    assert all(p.requires_grad for p in ttraining.tree_leaves(start.params))
    p2 = _flat(start.params)
    state, metrics = _torch_steps(start, 2)
    for t, j in zip(metrics, jax_run["metrics"][2:4]):
        assert t["lr_step"] == j["lr_step"]
        assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    _assert_params_close(state.params, jax_run["params"][4], p2)


# ------------------------------------------------ remat_policy="dots"

class _OpCount(TorchDispatchMode):
    """Counts the aten ops that run while it is active."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _remat_config(module, name, remat, policy):
    cfg = module.CONFIGS[name]
    if hasattr(cfg, "base"):
        return dataclasses.replace(cfg, base=dataclasses.replace(
            cfg.base, remat=remat, remat_policy=policy))
    return dataclasses.replace(cfg, remat=remat, remat_policy=policy)


def _loss_and_grads(loss_fn, params, batch):
    """Loss, gradients, and the aten ops counted in the forward and in the
    backward, on fresh leaves of ``params``."""
    tree = ttraining.tree_map(
        lambda t: t.detach().clone().requires_grad_(True), params)
    leaves = ttraining.tree_leaves(tree)
    fwd = _OpCount()
    with fwd:
        loss, _ = loss_fn(tree, batch)
    bwd = _OpCount()
    with bwd:
        grads = torch.autograd.grad(loss, leaves)
    return loss, grads, fwd.n, bwd.n


@pytest.mark.parametrize("model", ["llama", "moe"])
def test_dots_equals_nothing_and_jax(model):
    """remat_policy="dots" changes what the backward keeps, not what it
    computes: the f32 loss and every gradient equal "nothing"'s bit for
    bit (the recompute is the same arithmetic on the CPU), and the JAX
    package's "dots" step to the Llama tolerances (loss 1e-5 relative,
    gradients 1e-4 absolute)."""
    from ray_tpu.models import moe as jmoe
    from ray_tpu_torch.models import moe as tmoe

    jmod, tmod = {"llama": (jllama, tllama), "moe": (jmoe, tmoe)}[model]
    jc = _remat_config(jmod, "debug", True, "dots")
    jp = jmod.init_params(jc, jax.random.key(11))
    tp = params_from_jax(_np_tree(jp))
    tokens = _batch(seed=11)["tokens"]
    tb = {"tokens": torch.from_numpy(tokens)}
    res = {}
    for policy in ("nothing", "dots"):
        tc = _remat_config(tmod, "debug", True, policy)
        res[policy] = _loss_and_grads(
            lambda p, b: tmod.loss_fn(p, b, tc), tp, tb)[:2]
    (loss_n, grads_n), (loss_d, grads_d) = res["nothing"], res["dots"]
    assert torch.equal(loss_d, loss_n)
    assert all(torch.equal(a, b) for a, b in zip(grads_d, grads_n))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jmod.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jc),
        has_aux=True)(jp)
    np.testing.assert_allclose(loss_d.item(), float(jloss), rtol=1e-5)
    for g, j in zip(grads_d, jax.tree_util.tree_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-4)


@pytest.mark.parametrize("model", ["llama", "moe"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_dots_backward_recomputes_no_mm(model, early_stop):
    """Counted at the dispatcher: under "dots" the backward runs exactly
    the aten.mm calls of a backward without remat (the gradients'
    products), so it recomputes none. Under "nothing" it recomputes the
    layers' forward: with the checkpoint's early stop off, every aten.mm
    of it (all of the forward's but the head's, which is outside the
    layers); with it on (the default), every one up to the layer's last
    tensor the backward needs (Llama's down projection, whose output no
    backward reads, is skipped). aten.bmm (here the plain attention's
    and the experts' batched products) is recomputed under both."""
    from ray_tpu_torch.models import moe as tmoe

    tmod = {"llama": tllama, "moe": tmoe}[model]
    params = tmod.init_params(tmod.CONFIGS["debug"],
                              torch.Generator().manual_seed(12), "cpu")
    tb = {"tokens": torch.from_numpy(_batch(seed=12)["tokens"])}
    counts = {}
    with torch.utils.checkpoint.set_checkpoint_early_stop(early_stop):
        for remat, policy in ((False, "nothing"), (True, "nothing"),
                              (True, "dots")):
            cfg = _remat_config(tmod, "debug", remat, policy)
            counts[remat, policy] = _loss_and_grads(
                lambda p, b: tmod.loss_fn(p, b, cfg), params, tb)[2:]
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    fwd0, bwd0 = counts[False, "nothing"]
    n_layers = 2
    # per layer: q, k, v, o and the MLP's gate, up, down; or q, k, v, o
    # and the MoE router, dispatch and combine
    assert fwd0[mm] == 7 * n_layers + 1
    for key, (fwd, _) in counts.items():
        assert (fwd[mm], fwd[bmm]) == (fwd0[mm], fwd0[bmm]), key
    dots, nothing = counts[True, "dots"][1], counts[True, "nothing"][1]
    assert dots[mm] == bwd0[mm]
    skipped = {"llama": n_layers if early_stop else 0, "moe": 0}[model]
    assert nothing[mm] == bwd0[mm] + 7 * n_layers - skipped
    assert dots[bmm] == nothing[bmm] == bwd0[bmm] + fwd0[bmm]
