"""The systems under test, one package a traffic ``kind``: a mix
(``bench/traffic/<mix>.json``) names its kind, and ``bench/run.py`` imports
``bench.systems.<kind>``. A later kind of traffic (a simulation world, a
serving mix) is a package of its own here, and needs no edit elsewhere.

A kind's package provides:

* ``NUMBERS``: the names of the numbers its check can compare; a cell's
  limits file (``bench/workloads/<cell>.json``) gives a limit to some of
  them.
* ``System(cfg, traffic, seed, device, fault=None)``, whose methods a run
  calls in this order:

  - ``setup() -> (attempted, failed)``: the first unit of work at the
    cell's shapes, which warms every shape the window uses and reads what
    the check compares;
  - ``window(seconds) -> dict``: whole units of work until ``seconds``
    have passed, at least one, ending in a synchronize. Keys: ``wall_s``,
    ``samples`` (the work done, in the unit of ``samples_per_s``),
    ``model_flops`` (the model's work, nothing recomputed), ``attempted``
    and ``failed`` (the units that raised or gave a non-finite result),
    ``error`` where one raised, and what else it timed for the per-layer
    readers (``bench/metrics``);
  - ``free()``: drops the program's state;
  - ``compare() -> (numbers, worst)``: the plain reference's readings
    against the program's, run after ``free``; ``worst`` says where each
    number was read.
* ``readings(cell, seed, upper, device) -> dict``: the readings a cell's
  limits are set from (``bench/readings.py``).
* ``FAULTS``: the faults ``System`` can plant in its timed path.
"""
