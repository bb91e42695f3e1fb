"""The drivers of ``examples/``, on the port's entry points.

Each runs as ``python -m repro_torch.examples.<name>`` on the card (one
rank a card for the multi-rank ones, over NCCL) unless asked for the CPU
(``--device cpu``: gloo processes on the reference's grid):

* :mod:`.quickstart` — the NAP, RD and SMP allreduce engines and the
  permutation rounds each issued;
* :mod:`.nap_gradient_sync` — DP training with ``psum`` against NAP
  gradient sync, the NAP step's rounds, the simulated scalar-sync costs;
* :mod:`.train_lm` — a 12-layer, 66.7M-parameter LM trained with a crash
  and a resume; ``--compressed-smoke``: the int8 and int4 + error-feedback
  transports through the DP step;
* :mod:`.serve_decode` — four archs served through one continuous-batching
  engine.

:mod:`._world` is their launcher (one process per rank).
"""
