"""Analysis tools of the port, the counterparts of the JAX package's:

* `lint` / `rules` / `deadcode`: the AST linter behind
  ``python -m repro_torch.analysis`` (torch host syncs, rebuild hazards,
  plan-key hygiene, clamped ELL gathers, lock scopes, the LLM template's
  quarantine); it imports no torch;
* `smem` / `kernel_contracts`: the per-CTA budget model and the verifier
  of the CUDA kernel contracts (`repro_torch.kernels.contracts`), behind
  ``--kernel-contracts`` and `GraphSession`'s contract gate;
* `concurrency`: the runtime concurrency sanitizer that the serving
  layer's locks come from.

Nothing is re-exported here: the engine imports the sanitizer on every
start, while the linter is tooling that should not be paid for at run
time."""
