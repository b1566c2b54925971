"""APPO: asynchronous PPO — IMPALA's decoupled sample/learn architecture
with PPO's clipped surrogate objective on V-trace-corrected advantages
(port of ``ray_tpu/rl/appo.py``).

Reference: ``rllib/algorithms/appo/appo.py`` (APPO subclasses IMPALA)
and ``appo_learner.py`` / ``default_appo_rl_module.py``: behavior-policy
importance ratios feed both the V-trace value correction and the clip
surrogate; an optional KL penalty toward the behavior policy stabilizes
aggressively-async runs (reference default ``use_kl_loss=False``).

Everything but the loss rides :mod:`ray_tpu_torch.rl.impala`: aggregator
actors, the never-blocking sample router, LearnerGroup sharding, the
broadcast cadence and the learner's device are shared code paths,
exactly like the reference's subclassing structure.
"""

from __future__ import annotations

import dataclasses

from ray_tpu_torch.rl.impala import (IMPALA, IMPALAConfig, IMPALALearner,
                                     vtrace_corrections)


class APPOLearner(IMPALALearner):
    """IMPALA learner with the PPO clip surrogate (+ optional KL):
    overrides ONLY the loss hook; v-trace and the step/grad/apply
    scaffolding are the shared IMPALA code paths."""

    def __init__(self, params, *, clip: float = 0.2,
                 kl_coeff: float = 0.0, **kwargs):
        self._clip = clip
        self._kl_coeff = kl_coeff
        super().__init__(params, **kwargs)

    def _loss(self, params, batch, layout):
        import torch

        clip, kl_coeff = self._clip, self._kl_coeff
        logp, values, entropy = self._logp(params, batch)
        ratio = torch.exp(logp - batch["logp"])
        rho = ratio.detach()
        vs, adv = vtrace_corrections(
            values, batch, rho, gamma=self.gamma, rho_bar=self.rho_bar,
            c_bar=self.c_bar, layout=layout)
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        # PPO clip surrogate on the v-trace advantages (the APPO
        # difference vs IMPALA's plain -logp * adv)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv)
        pi_loss = -surrogate.mean()
        vf_loss = ((values - vs) ** 2).mean()
        # KL(behavior || current) estimated from the sampled actions
        kl = (batch["logp"] - logp).mean()
        total = (pi_loss + self.vf_coeff * vf_loss
                 - self.entropy_coeff * entropy + kl_coeff * kl)
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy, "kl": kl,
                       "mean_ratio": ratio.mean()}


class APPO(IMPALA):
    """Async PPO driver — IMPALA's training_step, APPO's loss."""


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip: float = 0.2
    kl_coeff: float = 0.0            # reference default: use_kl_loss=False
    lr: float = 3e-4
    entropy_coeff: float = 0.01

    @property
    def algo_class(self):
        return APPO

    def learner_cls(self):
        return APPOLearner

    def learner_kwargs(self) -> dict:
        kw = super().learner_kwargs()
        kw.update(clip=self.clip, kl_coeff=self.kl_coeff)
        return kw
