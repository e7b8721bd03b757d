"""One module per model family: everything of the benchmark that depends on
what a configuration's layers are.

A configuration file's ``model_type`` names its family's module,
``families/<model_type>.py`` (``harness.family_of``); a model type whose
family computes the same model as another's re-exports that module.  A
family module provides:

* sizes: ``dims(name, raw)``, the configuration file's keys read into a
  frozen dataclass with at least ``name``, ``vocab_size`` and
  ``padded_vocab`` (0 until ``harness.sized`` fills it from the port's
  configuration), refusing a file that its model cannot run as written;
* the port's configuration: ``port_config(dims, **overrides)``, the
  ``repro_torch`` configuration object for these sizes (``overrides``: a
  traffic mix's ``remat``), importing the program inside the function only;
* weights: ``leaf_specs(dims)``, (path in the port's parameter tree,
  shape, init) of every leaf in draw order, which ``weights.make_flat``
  turns into seeded tensors;
* the plain reference: ``last_logits`` (the (V,) logits at a prompt's last
  position, or (R, V) rows where the reference cannot tell which of its
  computations the configuration's precision makes, as at an MoE router's
  near tie: the check takes the row nearest the program's), ``served_gaps``,
  ``train``, ``cross_entropy`` and the products ``exact`` and ``fp8`` (the
  control), from a module of ``reference/`` that imports nothing of the
  program;
* the arithmetic: ``prefill_flops(dims, B, S)``,
  ``train_step_flops(dims, B, S)``, ``decode_step_bytes(dims, B,
  cache_len)``, and ``flash_calls(dims, B, S)``, the (B, Sq, Sk, H, KV, hd)
  shape of every flash call of one prefill call, one an attention layer.
  The card's peaks and the flash bound of one call are ``yardstick``'s.

A family needs only the pieces that its cells' kinds and metrics use.
"""
