"""RL library — RLlib-equivalent stack (port of ``ray_tpu/rl``).

Reference architecture (reference ``rllib/``): an ``Algorithm`` drives a
sample→learn loop over an EnvRunner actor fleet (CPU) and a Learner
(the GPU). The learner is a torch SGD step on its device, env runners are
numpy-only processes (no torch or CUDA in rollout workers), and fleet
fan-out goes through :class:`FaultTolerantActorManager` exactly as the
reference does (``rllib/utils/actor_manager.py:198``).

Beside PPO it has the JAX package's other algorithms — DQN, SAC and CQL
on the replay buffers, BC and MARWIL on offline JSON data, IMPALA and
APPO with aggregator actors and V-trace, DreamerV3's world model,
multi-agent PPO — and Podracer's scale-out (``Algorithm.scale_out``):
Sebulba's runner fleets streaming into a learner actor, and Anakin's
in-device act+learn loop over ``TorchCartPole``. Every learner takes an
explicit ``device`` (None means CUDA) and its random draws from a
``torch.Generator`` on that device, or as arguments.
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
from ray_tpu_torch.rl.dqn import (  # noqa: F401
    DQN,
    DQNConfig,
    DQNLearner,
    ReplayBuffer,
)
from ray_tpu_torch.rl.envs import (  # noqa: F401
    CartPoleEnv,
    JaxCartPole,
    TorchCartPole,
    make_env,
    register_jax_env,
)
from ray_tpu_torch.rl.podracer import (  # noqa: F401
    Anakin,
    FragmentBatch,
    PodracerConfig,
    PodracerError,
    SebulbaHandle,
)
from ray_tpu_torch.rl.impala import (  # noqa: F401
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
)
from ray_tpu_torch.rl.multi_agent import (  # noqa: F401
    CoordinationGameEnv,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rl.cql import (  # noqa: F401
    CQL,
    CQLConfig,
    CQLLearner,
)
from ray_tpu_torch.rl.marwil import (  # noqa: F401
    MARWIL,
    MARWILConfig,
)
from ray_tpu_torch.rl.offline import (  # noqa: F401
    BC,
    BCConfig,
    JsonReader,
    JsonWriter,
    collect,
)
from ray_tpu_torch.rl.sac import (  # noqa: F401
    SAC,
    SACConfig,
    SACLearner,
)
from ray_tpu_torch.rl.appo import (  # noqa: F401
    APPO,
    APPOConfig,
    APPOLearner,
)
from ray_tpu_torch.rl.dreamerv3 import (  # noqa: F401
    DreamerV3,
    DreamerV3Config,
    DreamerV3Learner,
)

from ray_tpu_torch.util.usage import record_library_usage as _record_usage
_record_usage("rl")
del _record_usage
