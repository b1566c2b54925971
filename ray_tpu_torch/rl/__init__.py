"""RL library — RLlib-equivalent stack (port of ``ray_tpu/rl``, its PPO
path).

Reference architecture (reference ``rllib/``): an ``Algorithm`` drives a
sample→learn loop over an EnvRunner actor fleet (CPU) and a Learner
(the GPU). The learner is a torch SGD step on its device, env runners are
numpy-only processes (no torch or CUDA in rollout workers), and fleet
fan-out goes through :class:`FaultTolerantActorManager` exactly as the
reference does (``rllib/utils/actor_manager.py:198``).

The JAX package's other algorithms (DQN, IMPALA, APPO, SAC, CQL, MARWIL,
DreamerV3), offline data, multi-agent envs and the replay buffers come in
a later slice, as do Podracer's Anakin and Sebulba; their names refuse
with their ROADMAP item until then (``common/status.py::WAITING``).
"""

from ray_tpu_torch.rl.actor_manager import FaultTolerantActorManager  # noqa: F401
from ray_tpu_torch.rl.algorithm import (  # noqa: F401
    Algorithm,
    AlgorithmConfig,
    PPO,
    PPOConfig,
)
from ray_tpu_torch.rl.connectors import (  # noqa: F401
    Connector,
    ConnectorPipeline,
    FrameStack,
    Lambda,
    ObsNormalizer,
)
from ray_tpu_torch.rl.envs import (  # noqa: F401
    CartPoleEnv,
    make_env,
    register_jax_env,
)

# the JAX package's rl names a later slice brings, by WAITING entry
_LATER = {
    "rl_later": (
        "DQN", "DQNConfig", "DQNLearner", "ReplayBuffer", "IMPALA",
        "IMPALAConfig", "IMPALALearner", "CoordinationGameEnv",
        "MultiAgentEnvRunner", "MultiAgentPPO", "MultiAgentPPOConfig", "CQL",
        "CQLConfig", "CQLLearner", "MARWIL", "MARWILConfig", "BC",
        "BCConfig", "JsonReader", "JsonWriter", "collect", "SAC",
        "SACConfig", "SACLearner", "APPO", "APPOConfig", "APPOLearner",
        "DreamerV3", "DreamerV3Config", "DreamerV3Learner"),
    "rl_anakin": (
        "Anakin", "FragmentBatch", "PodracerConfig", "PodracerError",
        "SebulbaHandle", "JaxCartPole"),
}
_WAITING = {name: item for item, names in _LATER.items() for name in names}


def __getattr__(name):
    if name in _WAITING:
        from ray_tpu_torch.common.status import not_ported

        raise not_ported(_WAITING[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from ray_tpu_torch.util.usage import record_library_usage as _record_usage  # noqa: E402
_record_usage("rl")
del _record_usage
