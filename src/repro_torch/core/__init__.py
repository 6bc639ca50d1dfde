"""The DeFTA engine: tasks, topology, gossip transport, trust, the round
programs (sync DeFTA, FedAvg, the async tick) and their drivers.

aggregation: outdegree-corrected mixing matrices + Markov/bias analysis
             (a numpy copy of the reference's)
defta:       synchronous multi-worker mode (Algorithm 1)
async_defta: asynchronous mode (§3.4), the fire-gated tick over the round
fedavg:      CFL-F / CFL-S / FedAdam centralized baselines
"""
from repro_torch.core import aggregation  # noqa: F401
from repro_torch.core.async_defta import run_async_defta  # noqa: F401
from repro_torch.core.fedavg import evaluate_server, run_fedavg  # noqa: F401
