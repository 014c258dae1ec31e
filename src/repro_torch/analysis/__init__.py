"""The contract checker (counterpart of ``repro.analysis``): each step
bundle declares what a call must do, and the lint runs the bundle matrix
and checks it.

- :mod:`~repro_torch.analysis.contracts` — the declarative per-bundle
  contract schema (pure data);
- :mod:`~repro_torch.analysis.passes`    — the recorder and the checks:
  collectives, launch budget, in-place state, dtype discipline (and the
  reference's manual-subgroup hazard, which cannot arise here);
- :mod:`~repro_torch.analysis.report`    — the machine-readable report;
- :mod:`~repro_torch.analysis.lint`      — the bundle×mesh matrix and its
  command line, ``python -m repro_torch.analysis.lint``.

The reference's HLO-text parser (``hlo_text.py``) and the HLO-reading
halves of ``collectives.py`` read compiled XLA modules and have no
counterpart: the port records what a call did instead.
"""
