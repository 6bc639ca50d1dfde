"""DeFTA as a drop-in for FedAvg in LM training: the port's ``--fl`` path
(``launch/train.py::train_lm``), each pod a federated worker with its own
replica and token stream, a DeFTA pod round every ``gossip_every`` steps
(``system``), checked against the plain reference (``check``)."""
from bench.systems.fl_lm.check import NUMBERS
from bench.systems.fl_lm.readings import readings
from bench.systems.fl_lm.system import FAULTS, System

__all__ = ["FAULTS", "NUMBERS", "System", "readings"]
