"""DreamerV3: model-based RL — world model + imagination actor-critic
(port of ``ray_tpu/rl/dreamerv3.py``).

Reference: ``rllib/algorithms/dreamerv3/dreamerv3.py`` (+
``dreamerv3_learner.py`` / ``dreamerv3_rl_module.py`` and the TF models
under ``utils/``).  The defining machinery:

- **RSSM world model** — GRU deterministic state ``h`` + discrete latent
  ``z`` (categoricals × classes, unimix 1%, straight-through gradients),
  encoder/decoder (symlog MSE), reward head (symlog twohot), continue
  head; KL with free bits and dyn/rep balancing (0.5 / 0.1).
- **Imagination training** — H-step rollouts in latent space from
  replayed posteriors; λ-returns; twohot critic with EMA regularizer;
  actor trained on percentile-normalized advantages with entropy bonus.
- **Sequence replay** — (B, L) windows of real experience, is_first
  resets.

The port: the update runs on the learner's device (None means CUDA) as
two Python loops, the world-model unroll over L and the imagination
rollout over H, with autograd through both (the JAX package's two
``lax.scan``s); every product is batched over B (or B·L). The JAX step
draws its categoricals from ``jax.random`` inside the jitted function;
here a categorical is argmax(logits + Gumbel noise), which is how
``jax.random.categorical`` draws, and :meth:`DreamerV3Learner.step` is
a function of its Gumbel draws (``wm`` (L, B, cats, classes), ``img_a``
(H, B·L, A), ``img_z`` (H, B·L, cats, classes)), which
:meth:`DreamerV3Learner.draws` makes from the learner's
``torch.Generator`` on its device. The twohot bins are
``torch.linspace(-10, 10, 41)``, within 4.8e-7 of ``jnp.linspace``'s.

Acting runs on the TRUE RSSM posterior latent through the stateful-module
channel (rl/module.py): :meth:`DreamerV3Learner.get_runner_weights`
exports the inference slice of the world model (GRU advance + encoder +
posterior + actor) as a numpy param dict, env runners carry the
(h, z, a) latent per episode and reset it on ``is_first`` exactly as the
trainer does, and replayed fragments record the per-step latent so
sequence windows inject the ACTED state at window starts instead of
burning in from zeros.  The actor/critic themselves train purely in
imagination, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.learner import _Adam, _tensors, value_and_grad
from ray_tpu_torch.rl.module import torch_gumbel
from ray_tpu_torch.rl.replay import SequenceReplay  # noqa: F401  (re-export)

# ---------------------------------------------------------------- helpers


def _symlog(x):
    import torch

    return torch.sign(x) * torch.log1p(torch.abs(x))


def _symexp(x):
    import torch

    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


_NUM_BINS = 41


def _bins(device):
    import torch

    return torch.linspace(-10.0, 10.0, _NUM_BINS, device=device)


def _one_hot(idx, n):
    """One-hot rows as a comparison (``F.one_hot`` checks its indices on
    the host, a device sync)."""
    import torch

    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _twohot(x):
    """Scalar (already symlog'd) → two-hot distribution over _bins()."""
    import torch

    b = _bins(x.device)
    x = torch.clamp(x, b[0], b[-1])
    idx = torch.clamp(torch.searchsorted(b, x.contiguous(), right=True) - 1,
                      0, _NUM_BINS - 2)
    lo, hi = b[idx], b[idx + 1]
    w_hi = (x - lo) / (hi - lo)
    oh_lo = _one_hot(idx, _NUM_BINS)
    oh_hi = _one_hot(idx + 1, _NUM_BINS)
    return oh_lo * (1.0 - w_hi)[..., None] + oh_hi * w_hi[..., None]


def _twohot_mean(logits):
    """Expected value (in symexp space) of a twohot head."""
    import torch

    probs = torch.softmax(logits, dim=-1)
    return _symexp((probs * _bins(logits.device)).sum(dim=-1))


def _dense_init(rng, fan_in, fan_out, scale=None):
    scale = np.sqrt(2.0 / fan_in) if scale is None else scale
    return ((rng.standard_normal((fan_in, fan_out)) * scale)
            .astype(np.float32), np.zeros(fan_out, np.float32))


def _mlp(params, prefix, x, n_layers):
    import torch

    for i in range(n_layers):
        x = torch.tanh(x @ params[f"{prefix}{i}_w"]
                       + params[f"{prefix}{i}_b"])
    return x


# ---------------------------------------------------------------- learner


class DreamerV3Learner:
    """World-model + imagination actor-critic update."""

    _EMA_KEYS = ("critic0_w", "critic0_b", "critic_logits_w",
                 "critic_logits_b")

    def __init__(self, obs_size: int, num_actions: int,
                 cfg: "DreamerV3Config", device=None):
        import torch

        from ray_tpu_torch import resolve_device

        self.device = resolve_device(device)
        self.cfg = cfg
        self.obs_size = obs_size
        self.num_actions = num_actions
        self.hid = cfg.units
        self.deter = cfg.deter
        self.cats = cfg.latent_categoricals
        self.classes = cfg.latent_classes
        self.zdim = self.cats * self.classes

        rng = np.random.default_rng(cfg.seed)
        p: Dict[str, np.ndarray] = {}

        def add(name, fi, fo, scale=None):
            p[f"{name}_w"], p[f"{name}_b"] = _dense_init(rng, fi, fo, scale)

        H, Z, U = self.deter, self.zdim, self.hid
        add("enc0", obs_size, U)
        add("post0", H + U, U)
        add("post_logits", U, Z, 0.01)
        add("prior0", H, U)
        add("prior_logits", U, Z, 0.01)
        # GRU: input [z, one_hot(action)] -> candidate/update/reset
        gin = Z + num_actions
        add("gru_x", gin, 3 * H)
        add("gru_h", H, 3 * H)
        add("dec0", H + Z, U)
        add("dec_out", U, obs_size, 0.01)
        # Reward/continue heads are ACTION-conditioned — r(s, a), c(s, a)
        # — a deliberate divergence from the reference's state-only heads:
        # fragments key rewards[t]/terminated[t] to the OUTGOING
        # transition (obs_t, a_t) and never record the terminal arrival
        # observation (runners reset in place), so a state-only head
        # cannot see which action ends the episode.
        add("rew0", H + Z + num_actions, U)
        add("rew_logits", U, _NUM_BINS, 0.0)  # zero-init (reference)
        add("cont0", H + Z + num_actions, U)
        add("cont_logit", U, 1, 0.01)
        add("actor0", H + Z, U)
        add("actor_logits", U, num_actions, 0.01)
        add("critic0", H + Z, U)
        add("critic_logits", U, _NUM_BINS, 0.0)

        self._params = _tensors(p, self.device)
        self._critic_ema = {k: self._params[k].clone()
                            for k in self._EMA_KEYS}
        self._opt = _Adam(cfg.lr, 100.0)
        self._opt_state = self._opt.init(self._params)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(cfg.seed)
        self._updates = 0

    # -------------------------------------------------------------- model
    def _unimix(self, logits):
        """1% uniform mixture on categorical probs (reference unimix):
        log-probs (..., cats, classes)."""
        import torch

        B = logits.shape[:-1]
        lg = logits.reshape(*B, self.cats, self.classes)
        probs = torch.softmax(lg, dim=-1)
        probs = 0.99 * probs + 0.01 / self.classes
        return torch.log(probs)

    def _sample_z(self, gumbel, logits):
        """Straight-through categorical sample at the Gumbel draw →
        flat one-hot (B, zdim)."""
        import torch

        B = logits.shape[:-1]
        lg = logits.reshape(*B, self.cats, self.classes)
        onehot = _one_hot((lg + gumbel).argmax(dim=-1), self.classes)
        probs = torch.softmax(lg, dim=-1)
        st = onehot + probs - probs.detach()
        return st.reshape(*B, self.zdim)

    def _gru(self, p, h, z, a_onehot):
        import torch

        D = self.deter
        x = torch.cat([z, a_onehot], -1)
        gx = x @ p["gru_x_w"] + p["gru_x_b"]
        gh = h @ p["gru_h_w"] + p["gru_h_b"]
        r = torch.sigmoid(gx[..., :D] + gh[..., :D])
        u = torch.sigmoid(gx[..., D:2 * D] + gh[..., D:2 * D])
        c = torch.tanh(gx[..., 2 * D:] + r * gh[..., 2 * D:])
        return u * c + (1.0 - u) * h

    def _kl_cat(self, lhs_logits, rhs_logits):
        """KL( Cat(lhs) || Cat(rhs) ) summed over categoricals."""
        import torch

        B = lhs_logits.shape[:-1]
        l1 = lhs_logits.reshape(*B, self.cats, self.classes)
        l2 = rhs_logits.reshape(*B, self.cats, self.classes)
        p1 = torch.softmax(l1, -1)
        return (p1 * (torch.log_softmax(l1, -1)
                      - torch.log_softmax(l2, -1))).sum(dim=(-2, -1))

    @staticmethod
    def _heads(p, h, z, a_oh):
        import torch

        hz = torch.cat([h, z], -1)
        hza = torch.cat([hz, a_oh], -1)
        dec = _mlp(p, "dec", hz, 1) @ p["dec_out_w"] + p["dec_out_b"]
        rew = _mlp(p, "rew", hza, 1) @ p["rew_logits_w"] + p["rew_logits_b"]
        cont = (_mlp(p, "cont", hza, 1) @ p["cont_logit_w"]
                + p["cont_logit_b"])[..., 0]
        return dec, rew, cont

    @staticmethod
    def _critic_logits(cp, h, z):
        import torch

        hz = torch.cat([h, z], -1)
        x = torch.tanh(hz @ cp["critic0_w"] + cp["critic0_b"])
        return x @ cp["critic_logits_w"] + cp["critic_logits_b"]

    def _actor_logits(self, p, h, z):
        import torch

        hz = torch.cat([h, z], -1)
        lg = _mlp(p, "actor", hz, 1) @ p["actor_logits_w"] \
            + p["actor_logits_b"]
        # 1% unimix on the ACTION distribution too (reference actor)
        probs = 0.99 * torch.softmax(lg, -1) + 0.01 / self.num_actions
        return torch.log(probs)

    def _prior(self, p, h):
        return self._unimix(_mlp(p, "prior", h, 1) @ p["prior_logits_w"]
                            + p["prior_logits_b"]).reshape(h.shape[0],
                                                           self.zdim)

    def _loss(self, p, ema, batch, draws):
        import torch
        import torch.nn.functional as F

        cfg = self.cfg
        A = self.num_actions
        H, Z = self.deter, self.zdim
        B, L = batch["actions"].shape
        obs = _symlog(batch["obs"])               # (B, L, obs)
        a_oh = _one_hot(batch["actions"], A)

        # world-model unroll: action a_{t-1} advances the state, then the
        # posterior sees obs_t; at the window start the replayed
        # pre-window action applies — the same advance the acting tower
        # performed. Window starts resume from the latent the policy
        # ACTED with (zeros when unavailable).
        h, z = batch["state_in_h"], batch["state_in_z"]
        hs, zs, posts, priors = [], [], [], []
        for t in range(L):
            a_prev = batch["state_in_a"] if t == 0 else a_oh[:, t - 1]
            h = self._gru(p, h, z, a_prev)
            h = torch.where(batch["is_first"][:, t, None],
                            torch.zeros_like(h), h)
            e = _mlp(p, "enc", obs[:, t], 1)
            post = self._unimix(
                _mlp(p, "post", torch.cat([h, e], -1), 1)
                @ p["post_logits_w"] + p["post_logits_b"]).reshape(B, Z)
            prior = self._prior(p, h)
            z = self._sample_z(draws["wm"][t], post)
            hs.append(h)
            zs.append(z)
            posts.append(post)
            priors.append(prior)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        posts, priors = torch.stack(posts, 1), torch.stack(priors, 1)

        dec, rew_logits, cont_logit = self._heads(p, hs, zs, a_oh)
        recon = ((dec - obs) ** 2).sum(-1).mean()
        rew_target = _twohot(_symlog(batch["rewards"]))
        rew_nll = -(rew_target * torch.log_softmax(rew_logits, -1)
                    ).sum(-1).mean()
        cont_target = 1.0 - batch["terminated"]
        cont_nll = (-cont_target * F.logsigmoid(cont_logit)
                    - (1.0 - cont_target) * F.logsigmoid(-cont_logit)
                    ).mean()
        # KL: free bits + dyn/rep balancing (reference 0.5 / 0.1)
        dyn = torch.clamp(self._kl_cat(posts.detach(), priors),
                          min=1.0).mean()
        rep = torch.clamp(self._kl_cat(posts, priors.detach()),
                          min=1.0).mean()
        wm_loss = recon + rew_nll + cont_nll + 0.5 * dyn + 0.1 * rep

        # ---------------- imagination rollout (actor-critic) ------
        h = hs.reshape(B * L, H).detach()
        z = zs.reshape(B * L, Z).detach()
        ih, iz, ialog, ia = [], [], [], []
        for i in range(cfg.horizon):
            alog = self._actor_logits(p, h, z)
            a = (alog + draws["img_a"][i]).argmax(dim=-1)
            h2 = self._gru(p, h, z, _one_hot(a, A))
            z2 = self._sample_z(draws["img_z"][i], self._prior(p, h2))
            ih.append(h)
            iz.append(z)
            ialog.append(alog)
            ia.append(a)
            h, z = h2, z2
        ih, iz = torch.stack(ih), torch.stack(iz)        # (Hor, BL, ·)
        ialog, ia = torch.stack(ialog), torch.stack(ia)
        _, irew_logits, icont_logit = self._heads(p, ih, iz, _one_hot(ia, A))
        irew = _twohot_mean(irew_logits)
        icont = torch.sigmoid(icont_logit)
        ival = _twohot_mean(self._critic_logits(p, ih, iz))
        ema_logits = self._critic_logits(ema, ih, iz)
        ival_ema = _twohot_mean(ema_logits)

        disc = cfg.gamma * icont
        # λ-returns backward over the horizon, bootstrapping on the
        # NEXT state's value: R_t = r_t + γc_t((1-λ)v_{t+1} + λR_{t+1})
        next_val = torch.cat([ival[1:], ival[-1:]], 0)
        nxt = ival[-1]
        rets = [None] * cfg.horizon
        for t in range(cfg.horizon - 1, -1, -1):
            nxt = irew[t] + disc[t] * ((1.0 - cfg.lmbda) * next_val[t]
                                       + cfg.lmbda * nxt)
            rets[t] = nxt
        rets = torch.stack(rets)                          # (Hor, BL)

        # critic: twohot NLL to λ-returns + EMA regularizer
        tgt = _twohot(_symlog(rets)).detach()
        clog = self._critic_logits(p, ih, iz)
        clog_lsm = torch.log_softmax(clog, -1)
        critic_nll = -(tgt * clog_lsm).sum(-1).mean()
        ema_reg = -(torch.softmax(ema_logits, -1).detach()
                    * clog_lsm).sum(-1).mean()
        critic_loss = critic_nll + cfg.critic_ema_reg * ema_reg

        # actor: percentile-normalized advantages (reference S)
        adv = rets - ival_ema
        flat = rets.detach().reshape(-1)
        lo = torch.quantile(flat, 0.05)
        hi = torch.quantile(flat, 0.95)
        scale = torch.clamp(hi - lo, min=1.0)
        logp = torch.log_softmax(ialog, -1)
        taken = logp.gather(-1, ia[..., None])[..., 0]
        ent = -(torch.softmax(ialog, -1) * logp).sum(-1)
        actor_loss = (-(adv / scale).detach() * taken
                      - cfg.entropy_coeff * ent).mean()

        total = wm_loss + critic_loss + actor_loss
        # continue-head calibration diagnostics: a healthy model
        # separates these; both near 1.0 means imagination never
        # terminates and the actor trains against a delusion
        cont_p = torch.sigmoid(cont_logit)
        term = batch["terminated"]
        p_term = (cont_p * term).sum() / torch.clamp(term.sum(), min=1.0)
        p_alive = (cont_p * (1 - term)).sum() / torch.clamp(
            (1 - term).sum(), min=1.0)
        aux = {"wm_loss": wm_loss, "recon": recon, "rew_nll": rew_nll,
               "kl_dyn": dyn, "critic_loss": critic_loss,
               "actor_loss": actor_loss,
               "cont_p_at_term": p_term, "cont_p_alive": p_alive,
               "imag_disc_mean": icont.mean(),
               "imagined_return_mean": rets.mean()}
        return total, aux

    # -------------------------------------------------------------- draws
    def draws(self, batch_size: int, seq_len: int) -> Dict[str, Any]:
        """The step's Gumbel draws for a (batch_size, seq_len) window
        batch, from the learner's generator on its device."""
        BL = batch_size * seq_len
        hor = self.cfg.horizon
        g, dev = self._gen, self.device
        return {
            "wm": torch_gumbel((seq_len, batch_size, self.cats,
                                self.classes), g, dev),
            "img_a": torch_gumbel((hor, BL, self.num_actions), g, dev),
            "img_z": torch_gumbel((hor, BL, self.cats, self.classes), g,
                                  dev)}

    def step(self, batch, draws) -> Dict[str, Any]:
        """One update from a device batch and the step's draws; metrics
        stay tensors (no host sync)."""
        loss, aux, grads = value_and_grad(self._loss, self._params,
                                          self._critic_ema, batch, draws)
        self._params, self._opt_state = self._opt.update(
            grads, self._opt_state, self._params)
        self._critic_ema = {k: 0.98 * e + 0.02 * self._params[k]
                            for k, e in self._critic_ema.items()}
        self._updates += 1
        return {"loss": loss, **aux}

    def _device_batch(self, batch: Dict[str, np.ndarray]):
        """A numpy window batch as the step's tensors: dtypes set, and
        zero window-start latents for batches built without recorded
        acting state (unit tests, external data)."""
        import torch

        tb = _tensors(batch, self.device)
        tb["rewards"] = tb["rewards"].float()
        tb["terminated"] = tb["terminated"].float()
        tb["is_first"] = tb["is_first"].bool()
        B = tb["actions"].shape[0]
        for k, dim in (("state_in_h", self.deter), ("state_in_z", self.zdim),
                       ("state_in_a", self.num_actions)):
            if k in tb:
                tb[k] = tb[k].float()
            else:
                tb[k] = torch.zeros((B, dim), dtype=torch.float32,
                                    device=self.device)
        return tb

    def update(self, batch: Dict[str, np.ndarray],
               draws: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        B, L = np.asarray(batch["actions"]).shape
        draws = (self.draws(B, L) if draws is None
                 else _tensors(draws, self.device))
        return {k: float(v) for k, v in self.step(
            self._device_batch(batch), draws).items()}

    # the inference-only slice of the world model a runner needs to act
    # on the true posterior latent (rl/module.py RSSM family)
    _ACTING_KEYS = ("enc0_w", "enc0_b", "post0_w", "post0_b",
                    "post_logits_w", "post_logits_b",
                    "gru_x_w", "gru_x_b", "gru_h_w", "gru_h_b",
                    "actor0_w", "actor0_b",
                    "actor_logits_w", "actor_logits_b")

    def get_runner_weights(self) -> Dict[str, np.ndarray]:
        """The RSSM acting tower in the rl/module.py stateful schema:
        env runners thread the (h, z, a) latent through
        ``np_stateful_sample_batch`` and act on the actor's true
        posterior-conditioned distribution — no distillate."""
        out = {k: self._params[k].detach().cpu().numpy()
               for k in self._ACTING_KEYS}
        out["rssm_meta"] = np.asarray([self.cats, self.classes], np.int32)
        return out

    def get_weights(self) -> Dict[str, np.ndarray]:
        """Every parameter of the world model, actor and critic."""
        return {k: v.detach().cpu().numpy() for k, v in self._params.items()}


# -------------------------------------------------------------- algorithm


class DreamerV3(Algorithm):
    """Sample real steps (acting on the RSSM posterior latent) → sequence
    replay with recorded latents → world-model + imagination updates →
    broadcast the refreshed acting tower."""

    def __init__(self, config: "DreamerV3Config"):
        super().__init__(config)
        self.learner = DreamerV3Learner(
            self._env_probe["obs_size"], self._env_probe["num_actions"],
            config, device=config.learner_device)
        self.replay = SequenceReplay(config.replay_capacity,
                                     config.seq_len, seed=config.seed)

    def get_weights(self):
        return self.learner.get_runner_weights()

    def training_step(self) -> Dict[str, Any]:
        cfg: DreamerV3Config = self.config  # type: ignore[assignment]
        fragments = self._sample_fragments()
        if not fragments:
            raise RuntimeError("no healthy env runners produced samples")
        returns: List[float] = []
        for f in fragments:
            self.replay.add_fragment(f)
            returns.extend(f["episode_returns"])
        metrics: Dict[str, float] = {}
        if len(self.replay) >= cfg.learning_starts and \
                self.replay.has_sequences(cfg.batch_size):
            for _ in range(cfg.updates_per_iteration):
                metrics = self.learner.update(
                    self.replay.sample(cfg.batch_size))
        self._weights_version += 1
        self._return_window = (self._return_window + returns)[-100:]
        return {
            "env_runners": {
                "episode_return_mean": self.episode_return_mean(),
                "num_episodes": len(returns),
                "num_env_steps_sampled": sum(
                    len(f["obs"]) for f in fragments),
                "num_healthy_workers":
                    self.env_runner_group.num_healthy_actors(),
            },
            "learners": {"default_policy": metrics},
            "replay_buffer_size": len(self.replay),
        }


@dataclasses.dataclass
class DreamerV3Config(AlgorithmConfig):
    # 1e-3 (vs the reference's ~4e-4 for far bigger nets): at this tiny
    # scale the world model is the wall-clock bottleneck for CI-budget
    # learning, and the smaller nets tolerate the hotter rate
    lr: float = 1e-3
    gamma: float = 0.997
    lmbda: float = 0.95
    horizon: int = 15
    seq_len: int = 16
    batch_size: int = 16
    units: int = 64
    deter: int = 64
    latent_categoricals: int = 8
    latent_classes: int = 8
    entropy_coeff: float = 3e-3
    critic_ema_reg: float = 1.0
    replay_capacity: int = 100_000
    learning_starts: int = 500
    updates_per_iteration: int = 8
    algo_class = DreamerV3
