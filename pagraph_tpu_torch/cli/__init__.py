"""Command-line entry points (the port of ``pagraph_tpu/cli/``), run as
``python -m pagraph_tpu_torch.cli.<name>``:

* training: ``train``, ``launch`` and ``scalebench`` over the shared flags
  of ``common``;
* offline, host code with no device flag: ``preprocess``, ``convert``,
  ``partition``, ``verify_partition``, and ``analyze count-vnum`` and
  ``cache-oracle``;
* serving and measurement: ``eval``, ``infer`` and ``analyze load-break``.

Each command that touches the device runs on the card unless
``--cpu-devices N`` asks for the CPU."""
