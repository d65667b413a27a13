"""Static and step analysis of the port: machine-checked repo contracts.

The port of the JAX package's ``analysis/``, in two layers:

- ``repro_torch.analysis.staticcheck`` — a stdlib-only AST lint engine (no
  torch, no jax) with an ``RL###`` rule registry: the syntax and
  undefined-name basics plus the port's determinism and wire-honesty
  contracts, over the port's own files.
- ``repro_torch.analysis.step_checks`` — an analyzer of one eager
  distributed train step (imports torch): the payload whitelist, the
  decode-site accounting held to the kernel wrappers' counts, no float64
  and no host reads inside the step.

Entry point: ``python -m repro_torch.analysis.lint [--sweep]``.

This module deliberately imports nothing, so ``import
repro_torch.analysis.lint`` stays free of torch.
"""
