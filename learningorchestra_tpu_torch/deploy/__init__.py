"""The port's deployment: one machine's bring-up, its supervisor, and the
cluster driver.

Counterpart of the repository's ``deploy/`` (``run.sh``, ``stack.py``,
``cluster.py``), which launch only the JAX package:

- :mod:`.preflight` — every deployment knob validated before bring-up
  (``deploy/run.sh``'s heredoc, against the port's modules);
- :mod:`.run` — ``python -m learningorchestra_tpu_torch.deploy.run
  [data_dir]``: the preflight, then the all-in-one runner;
- :mod:`.stack` — ``python -m learningorchestra_tpu_torch.deploy.stack
  [data_dir]``: the supervised topology of one machine (store plane,
  seven services or the multi-host runtime group, the serving fleet,
  worker-only machines);
- :mod:`.cluster` — ``python -m learningorchestra_tpu_torch.deploy.cluster
  up|render <manifest.json>``: one stack a machine, wired and supervised
  from a manifest.

The stack and the cluster driver import only the standard library (and
the preflight's fault table), so they run before anything of the card is
touched; every child they start runs on the card unless its environment
asks for the CPU (``LO_DEVICE=cpu``).
"""
