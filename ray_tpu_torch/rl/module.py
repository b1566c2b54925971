"""RLModule equivalent: policy + value networks with twin implementations
(port of ``ray_tpu/rl/module.py``).

Reference: ``rllib/core/rl_module/`` — one module definition used in two
roles: inference-only copies on env runners, trainable copy on learners.
The trainable copy is torch (:func:`torch_forward`,
:func:`torch_lstm_forward_seq`, on the learner's device); the inference
copy is pure numpy so rollout workers never load torch or CUDA. Both
share one param dict (numpy arrays at the boundary), initialised by numpy
from a seed, so both packages start from the same weights.

Policy and value are separate towers (no shared trunk): the value
regression's large early losses otherwise dominate the shared features and
stall policy learning at this scale.

Stateful-module contract (reference ``RLModule.get_initial_state``,
``rllib/core/rl_module/rl_module.py:653``): modules that carry recurrent
state expose

- ``get_initial_state(params, batch_size)`` → dict of per-env state
  arrays (``{}`` for feedforward modules);
- ``np_stateful_sample_batch(params, obs, state, is_first, rng)`` →
  ``(actions, logps, values, next_state)`` — the numpy acting step. The
  module owns its OWN reset semantics for ``is_first`` rows (an LSTM
  zeroes ``h``/``c`` before the step; an RSSM zeroes the deterministic
  state after the GRU advance, exactly as its trainer does), so env
  runners never special-case per family;
- a matching sequence forward for the learner (e.g.
  ``torch_lstm_forward_seq``) that re-applies the same resets in one loop
  over the window, with the carried state injected at the window start
  (burn-in-free).

Env runners record the PRE-step carried state per step (``state_in``
columns) plus the ``is_first`` flag; sequence windows then ship the
recorded state at window starts and replay resets from the flags.
Module families are detected by marker keys in the one shared param
pytree: ``lstm_wx`` (LSTM policy), ``gru_x_w`` (RSSM acting tower),
``mu_w`` (continuous squashed-Gaussian), else feedforward-discrete —
so dispatch needs no per-algorithm branching anywhere.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

Params = Dict[str, np.ndarray]


def init_policy_params(obs_size: int, num_actions: int,
                       hidden: Tuple[int, ...] = (64, 64),
                       seed: int = 0) -> Params:
    rng = np.random.default_rng(seed)
    params: Params = {}
    sizes = (obs_size,) + hidden

    def dense(name, fan_in, fan_out, scale):
        params[f"{name}_w"] = (rng.standard_normal((fan_in, fan_out))
                               * scale).astype(np.float32)
        params[f"{name}_b"] = np.zeros(fan_out, np.float32)

    for tower in ("p", "v"):
        for i in range(len(hidden)):
            dense(f"{tower}{i}", sizes[i], sizes[i + 1],
                  np.sqrt(2.0 / sizes[i]))
    # small-init policy head → near-uniform initial policy
    dense("pi", sizes[-1], num_actions, 0.01)
    dense("vh", sizes[-1], 1, np.sqrt(1.0 / sizes[-1]))
    return params


def _n_hidden(params) -> int:
    n = 0
    while f"p{n}_w" in params:
        n += 1
    return n


def np_forward(params: Params, obs: np.ndarray):
    """(B, obs) → (logits (B, A), value (B,)). Pure numpy (env runners)."""
    x = v = obs
    for i in range(_n_hidden(params)):
        x = np.tanh(x @ params[f"p{i}_w"] + params[f"p{i}_b"])
        v = np.tanh(v @ params[f"v{i}_w"] + params[f"v{i}_b"])
    logits = x @ params["pi_w"] + params["pi_b"]
    value = (v @ params["vh_w"] + params["vh_b"])[:, 0]
    return logits, value


def torch_forward(params, obs):
    """Same network in torch (learners; the JAX package's
    ``jax_forward``): ``params`` a dict of tensors, ``obs`` (B, obs)."""
    import torch

    x = v = obs
    for i in range(_n_hidden(params)):
        x = torch.tanh(x @ params[f"p{i}_w"] + params[f"p{i}_b"])
        v = torch.tanh(v @ params[f"v{i}_w"] + params[f"v{i}_b"])
    logits = x @ params["pi_w"] + params["pi_b"]
    value = (v @ params["vh_w"] + params["vh_b"])[:, 0]
    return logits, value


def torch_gumbel(shape, generator, device):
    """Gumbel(0, 1) noise on ``device`` from ``generator``: -log of an
    Exp(1) draw. argmax(logits + this) is a categorical draw, the way
    ``jax.random.categorical`` draws (the learners' random draws)."""
    import torch

    e = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(e)


def np_sample_action(params: Params, obs: np.ndarray,
                     rng: np.random.Generator):
    """Single-obs categorical sample → (action, logp, value)."""
    logits, value = np_forward(params, obs[None])
    logits = logits[0] - logits[0].max()
    p = np.exp(logits)
    p /= p.sum()
    action = int(rng.choice(len(p), p=p))
    return action, float(np.log(p[action] + 1e-20)), float(value[0])


def _np_categorical_sample(p: np.ndarray, rng: np.random.Generator):
    """Vectorized categorical draw over probs (..., K) → (idx (...,),
    logp (...,)). Gumbel-max: one vectorized draw instead of N
    rng.choice calls."""
    g = rng.gumbel(size=p.shape)
    idx = (np.log(p + 1e-20) + g).argmax(axis=-1)
    logp = np.log(np.take_along_axis(
        p, idx[..., None], axis=-1)[..., 0] + 1e-20)
    return idx, logp


def np_sample_actions_batch(params: Params, obs: np.ndarray,
                            rng: np.random.Generator):
    """Vectorized categorical sample over a batch of observations:
    (N, obs) → (actions (N,), logps (N,), values (N,)). One forward matmul
    for the whole env vector — the point of vectorized env runners
    (reference rllib/env/vector/)."""
    logits, values = np_forward(params, obs)
    actions, logps = _np_categorical_sample(
        _np_softmax(logits, axis=1), rng)
    return actions.astype(np.int32), logps.astype(np.float32), \
        values.astype(np.float32)


# ----------------------------------------------------------- continuous
# Tanh-squashed Gaussian policy (SAC-style, reference
# rllib/algorithms/sac/sac_learner.py + torch squashed-gaussian dist):
# trunk "c{i}" -> heads "mu" and "ls" (state-dependent log-std), plus
# "action_scale" bounds. Detected by `"mu_w" in params` — env runners
# dispatch on it with no per-algorithm branching.

LOGSTD_MIN, LOGSTD_MAX = -5.0, 2.0


def init_continuous_policy_params(obs_size: int, action_dim: int,
                                  hidden: Tuple[int, ...] = (64, 64),
                                  seed: int = 0,
                                  action_scale: float = 1.0) -> Params:
    rng = np.random.default_rng(seed)
    params: Params = {}
    sizes = (obs_size,) + hidden

    def dense(name, fan_in, fan_out, scale):
        params[f"{name}_w"] = (rng.standard_normal((fan_in, fan_out))
                               * scale).astype(np.float32)
        params[f"{name}_b"] = np.zeros(fan_out, np.float32)

    for i in range(len(hidden)):
        dense(f"c{i}", sizes[i], sizes[i + 1], np.sqrt(2.0 / sizes[i]))
    dense("mu", sizes[-1], action_dim, 0.01)
    dense("ls", sizes[-1], action_dim, 0.01)
    params["action_scale"] = np.asarray(action_scale, np.float32)
    return params


def _n_cont_hidden(params) -> int:
    n = 0
    while f"c{n}_w" in params:
        n += 1
    return n


def np_continuous_dist(params: Params, obs: np.ndarray):
    """(B, obs) → (mu (B, A), std (B, A)) of the pre-squash Gaussian."""
    x = obs
    for i in range(_n_cont_hidden(params)):
        x = np.tanh(x @ params[f"c{i}_w"] + params[f"c{i}_b"])
    mu = x @ params["mu_w"] + params["mu_b"]
    logstd = np.clip(x @ params["ls_w"] + params["ls_b"],
                     LOGSTD_MIN, LOGSTD_MAX)
    return mu, np.exp(logstd)


def np_sample_continuous_batch(params: Params, obs: np.ndarray,
                               rng: np.random.Generator):
    """(N, obs) → (actions (N, A) f32, logps (N,), values zeros (N,)).
    Values are zeros: off-policy consumers (SAC) bootstrap from their own
    critics, not runner-side value estimates."""
    mu, std = np_continuous_dist(params, obs)
    eps = rng.standard_normal(mu.shape)
    pre = mu + std * eps
    scale = float(params["action_scale"])
    act = np.tanh(pre) * scale
    logp = (-0.5 * (eps ** 2 + np.log(2 * np.pi)) - np.log(std)
            - np.log(scale * (1 - np.tanh(pre) ** 2) + 1e-6)).sum(axis=1)
    return (act.astype(np.float32), logp.astype(np.float32),
            np.zeros(len(obs), np.float32))


def is_continuous(params: Params) -> bool:
    return "mu_w" in params


def action_spec(params: Params):
    """(trailing action shape, dtype) a runner should buffer for."""
    if is_continuous(params):
        return (params["mu_b"].shape[0],), np.float32
    return (), np.int32


# ------------------------------------------------------------- stateful
# Recurrent policy schema (see module docstring). Two families:
#
# - LSTM policy ("lstm_wx" marker): TWIN recurrent towers — obs
#   embedding -> LSTM cell -> head, separately for policy and value
#   (same twin-tower rationale as the MLP above: a shared trunk lets the
#   value regression's large early losses dominate the recurrent
#   features and stall policy learning at this scale — observed as a
#   flat return curve).  State: {"h","c"} policy tower, {"hv","cv"}
#   value tower, each (B, H).
# - RSSM acting tower ("gru_x_w" marker): the inference-only slice of a
#   DreamerV3 world model (GRU advance + posterior + actor), shipped by
#   rl/dreamerv3.py so env runners act on the TRUE latent.
#   State: {"h": (B, H), "z": (B, Z), "a": (B, A) one-hot prev action}.


def is_stateful(params: Params) -> bool:
    return "lstm_wx" in params or "gru_x_w" in params


def init_lstm_policy_params(obs_size: int, num_actions: int,
                            hidden: int = 64, seed: int = 0) -> Params:
    rng = np.random.default_rng(seed)
    params: Params = {}

    def dense(name, fan_in, fan_out, scale):
        params[f"{name}_w"] = (rng.standard_normal((fan_in, fan_out))
                               * scale).astype(np.float32)
        params[f"{name}_b"] = np.zeros(fan_out, np.float32)

    def lstm(prefix):
        params[f"{prefix}wx"] = (
            rng.standard_normal((hidden, 4 * hidden))
            * np.sqrt(1.0 / hidden)).astype(np.float32)
        params[f"{prefix}wh"] = (
            rng.standard_normal((hidden, 4 * hidden))
            * np.sqrt(1.0 / hidden)).astype(np.float32)
        b = np.zeros(4 * hidden, np.float32)
        b[hidden:2 * hidden] = 1.0      # forget-gate bias: remember early
        params[f"{prefix}b"] = b

    dense("emb", obs_size, hidden, np.sqrt(2.0 / obs_size))
    lstm("lstm_")                       # policy tower (family marker)
    dense("vemb", obs_size, hidden, np.sqrt(2.0 / obs_size))
    lstm("lstm_v_")                     # value tower
    # small-init policy head → near-uniform initial policy (as above)
    dense("pi", hidden, num_actions, 0.01)
    dense("vh", hidden, 1, np.sqrt(1.0 / hidden))
    return params


def get_initial_state(params: Params, batch_size: int = 1
                      ) -> Dict[str, np.ndarray]:
    """Zero state sized for ``batch_size`` envs; ``{}`` if feedforward."""
    if "lstm_wx" in params:
        H = params["lstm_wh"].shape[0]
        z = np.zeros((batch_size, H), np.float32)
        return {"h": z, "c": z.copy(), "hv": z.copy(), "cv": z.copy()}
    if "gru_x_w" in params:
        H = params["gru_h_w"].shape[0]
        Z = params["post_logits_w"].shape[1]
        A = params["actor_logits_w"].shape[1]
        return {"h": np.zeros((batch_size, H), np.float32),
                "z": np.zeros((batch_size, Z), np.float32),
                "a": np.zeros((batch_size, A), np.float32)}
    return {}


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _np_lstm_cell(wx, wh, b, x, h, c):
    H = h.shape[1]
    z = x @ wx + h @ wh + b
    i = _np_sigmoid(z[:, :H])
    f = _np_sigmoid(z[:, H:2 * H])
    g = np.tanh(z[:, 2 * H:3 * H])
    o = _np_sigmoid(z[:, 3 * H:])
    c2 = f * c + i * g
    return o * np.tanh(c2), c2


def np_lstm_step(params: Params, obs: np.ndarray,
                 state: Dict[str, np.ndarray], is_first: np.ndarray):
    """One batched twin-tower LSTM step: (B, obs) → (logits, values,
    next_state). Rows flagged ``is_first`` restart from zero state
    BEFORE the step."""
    first = np.asarray(is_first, bool)[:, None]

    def tower(emb, prefix, hk, ck):
        h = np.where(first, 0.0, state[hk]).astype(np.float32)
        c = np.where(first, 0.0, state[ck]).astype(np.float32)
        x = np.tanh(obs @ params[f"{emb}_w"] + params[f"{emb}_b"])
        return _np_lstm_cell(params[f"{prefix}wx"], params[f"{prefix}wh"],
                             params[f"{prefix}b"], x, h, c)

    hp, cp = tower("emb", "lstm_", "h", "c")
    hv, cv = tower("vemb", "lstm_v_", "hv", "cv")
    logits = hp @ params["pi_w"] + params["pi_b"]
    values = (hv @ params["vh_w"] + params["vh_b"])[:, 0]
    return (logits, values.astype(np.float32),
            {"h": hp.astype(np.float32), "c": cp.astype(np.float32),
             "hv": hv.astype(np.float32), "cv": cv.astype(np.float32)})


def torch_lstm_step(params, obs, state, is_first):
    """The same twin-tower cell in torch (one step of the sequence loop;
    the JAX package's ``jax_lstm_step``). ``state`` is a dict
    {"h","c","hv","cv"} of (B, H) tensors, ``is_first`` (B,) bool."""
    import torch

    first = is_first[:, None]
    H = params["lstm_wh"].shape[0]

    def cell(wx, wh, b, x, h, c):
        z = x @ wx + h @ wh + b
        i = torch.sigmoid(z[:, :H])
        f = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:3 * H])
        o = torch.sigmoid(z[:, 3 * H:])
        c2 = f * c + i * g
        return o * torch.tanh(c2), c2

    def tower(emb, prefix, hk, ck):
        h = torch.where(first, torch.zeros_like(state[hk]), state[hk])
        c = torch.where(first, torch.zeros_like(state[ck]), state[ck])
        x = torch.tanh(obs @ params[f"{emb}_w"] + params[f"{emb}_b"])
        return cell(params[f"{prefix}wx"], params[f"{prefix}wh"],
                    params[f"{prefix}b"], x, h, c)

    hp, cp = tower("emb", "lstm_", "h", "c")
    hv, cv = tower("vemb", "lstm_v_", "hv", "cv")
    logits = hp @ params["pi_w"] + params["pi_b"]
    values = (hv @ params["vh_w"] + params["vh_b"])[:, 0]
    return logits, values, {"h": hp, "c": cp, "hv": hv, "cv": cv}


def torch_lstm_forward_seq(params, obs, state, is_first):
    """Learner-side sequence forward (the JAX package's
    ``jax_lstm_forward_seq``, whose ``lax.scan`` is this loop over L):
    (B, L, obs) + injected window-start state dict → (logits (B, L, A),
    values (B, L)), re-applying the acting-time ``is_first`` resets
    mid-window."""
    import torch

    carry = dict(state)
    logits, values = [], []
    for t in range(obs.shape[1]):
        lg, v, carry = torch_lstm_step(params, obs[:, t], carry,
                                       is_first[:, t])
        logits.append(lg)
        values.append(v)
    return torch.stack(logits, dim=1), torch.stack(values, dim=1)


# -------- RSSM acting tower (numpy mirror of DreamerV3Learner's model)

def _np_symlog(x):
    return np.sign(x) * np.log1p(np.abs(x))


def _np_softmax(x, axis=-1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def np_rssm_advance(params: Params, obs: np.ndarray,
                    state: Dict[str, np.ndarray], is_first: np.ndarray):
    """Deterministic half of the RSSM acting step: GRU advance on
    (h, z_prev, a_prev), post-advance ``is_first`` reset (matching the
    trainer, which zeroes h AFTER the GRU), then posterior logits with
    1% unimix over the symlog'd observation. Returns (h2, post_probs
    (B, cats, classes))."""
    h, z, a = state["h"], state["z"], state["a"]
    D = params["gru_h_w"].shape[0]
    meta = params["rssm_meta"]
    cats, classes = int(meta[0]), int(meta[1])
    x = np.concatenate([z, a], axis=-1)
    gx = x @ params["gru_x_w"] + params["gru_x_b"]
    gh = h @ params["gru_h_w"] + params["gru_h_b"]
    r = _np_sigmoid(gx[:, :D] + gh[:, :D])
    u = _np_sigmoid(gx[:, D:2 * D] + gh[:, D:2 * D])
    cand = np.tanh(gx[:, 2 * D:] + r * gh[:, 2 * D:])
    h2 = u * cand + (1.0 - u) * h
    h2 = np.where(np.asarray(is_first, bool)[:, None], 0.0, h2)
    e = np.tanh(_np_symlog(obs) @ params["enc0_w"] + params["enc0_b"])
    pl = (np.tanh(np.concatenate([h2, e], -1) @ params["post0_w"]
                  + params["post0_b"])
          @ params["post_logits_w"] + params["post_logits_b"])
    probs = _np_softmax(pl.reshape(len(obs), cats, classes), -1)
    probs = 0.99 * probs + 0.01 / classes
    return h2.astype(np.float32), probs


def _np_rssm_sample_batch(params: Params, obs: np.ndarray,
                          state: Dict[str, np.ndarray],
                          is_first: np.ndarray, rng: np.random.Generator):
    B = len(obs)
    A = params["actor_logits_w"].shape[1]
    h2, post = np_rssm_advance(params, obs, state, is_first)
    cats, classes = post.shape[1], post.shape[2]
    idx, _ = _np_categorical_sample(post, rng)   # per-categorical draw
    z2 = np.eye(classes, dtype=np.float32)[idx].reshape(
        B, cats * classes)
    alog = (np.tanh(np.concatenate([h2, z2], -1) @ params["actor0_w"]
                    + params["actor0_b"])
            @ params["actor_logits_w"] + params["actor_logits_b"])
    ap = 0.99 * _np_softmax(alog, -1) + 0.01 / A   # trainer's action unimix
    actions, logps = _np_categorical_sample(ap, rng)
    a2 = np.eye(A, dtype=np.float32)[actions]
    # values are zeros: the Dreamer critic lives in imagination, runners
    # never estimate values (same contract as the continuous sampler)
    return (actions.astype(np.int32), logps.astype(np.float32),
            np.zeros(B, np.float32),
            {"h": h2, "z": z2, "a": a2})


def np_stateful_sample_batch(params: Params, obs: np.ndarray,
                             state: Dict[str, np.ndarray],
                             is_first: np.ndarray,
                             rng: np.random.Generator):
    """Vectorized stateful acting step: (N, obs) + carried state →
    (actions (N,), logps (N,), values (N,), next_state). Dispatches on
    the module family's marker key; each family applies its own
    ``is_first`` reset semantics internally."""
    if "gru_x_w" in params:
        return _np_rssm_sample_batch(params, obs, state, is_first, rng)
    logits, values, next_state = np_lstm_step(params, obs, state, is_first)
    actions, logps = _np_categorical_sample(_np_softmax(logits, -1), rng)
    return (actions.astype(np.int32), logps.astype(np.float32),
            values, next_state)


def np_stateful_values(params: Params, obs: np.ndarray,
                       state: Dict[str, np.ndarray],
                       is_first: np.ndarray) -> np.ndarray:
    """Value estimates WITHOUT advancing the carried state (bootstrap at
    fragment ends). RSSM runners return zeros (no runner-side critic)."""
    if "gru_x_w" in params:
        return np.zeros(len(obs), np.float32)
    _, values, _ = np_lstm_step(params, obs, state, is_first)
    return values
