"""Architecture modules: everything the harness knows of one model
architecture, found by the ``"arch"`` key of a configuration file
(``configs/<config>.json``) as ``arch/<arch>.py`` (``pb_core/spec.py``).
A new architecture is added by adding files; no harness file changes.

A module provides, for a configuration file's dict ``conf`` (its
published keys, its ``"run"`` block, and any overrides a test applies):

- ``port_config(conf, **overrides)``: the port's config for the file,
  with the ``"run"`` block applied, then `overrides`. It has
  ``vocab_size``, which the traffic draws its token ids from.
- ``build_params(conf, seed, device, cfg)``: the port's model with the
  run's seeded weights, drawn through ``pb_core/weights.py`` in the layout
  the architecture states beside its reference, on the device, in the
  served dtype.
- ``forward(params, tokens, cfg)``: the port's scoring entry: token ids
  [b, t] to logits [b, t, vocab]. It looks the port's function up at
  each call, so a test that patches the port reaches the timed path.
- ``Reference``: the plain float32 model the check holds the program to
  (``pb_core/check.py``): ``Reference(conf, seed, device, *,
  weight_dtype=torch.bfloat16, matmul_fp8=False)`` with ``.device``,
  ``.final_hidden(seqs, router_margins=None)`` (normed final hidden
  states of each 1-D token tensor; for a mixture of experts a list given
  as `router_margins` receives each token's smallest router margin),
  ``.head()`` and ``.logits_rows(h, rows, head)``. It draws its weights
  again from the seed and imports neither JAX nor anything of the port.
- ``score_flops(conf, t)``, ``prefill_flops(conf, n)`` and
  ``decode_flops(conf, context)``: the model FLOPs a t-token document
  scored, an n-token prompt prefilled and one token decoded at `context`
  visible keys need (``mfu.score``, ``mfu.serve``).
- ``tiny(conf)``: the overrides that cut the architecture to the size the
  CPU tests run it at.

and may provide (``pb_core/spec.py`` gives the defaults):

- ``kernels(cfg)``: ``{key: regex}``, the device kernel names of the
  architecture's hand-written kernels. Both drivers hand them to their
  traced slice, whose summary then holds each key's launches
  (``summary["kernels"][key]``: start and device seconds). Default ``{}``.
- ``kernel_work(cfg, key, slice_rec)``: the ``(FLOPs, bytes)`` of each
  launch of `key` that the traced slice drove, in order, or None where it
  cannot say; `slice_rec` is ``rec["slice"]`` as ``drivers/`` record it
  (score: the documents' lengths; serve: each admission's prompt tokens,
  each burst's active slots and steps, and the deltas of
  ``engine.stats()`` over the slice). The arithmetic lives in ``roofline/<kernel>.py``, and a metric
  ``metrics/<kernel>_roofline.py`` returns
  ``roofline.share.kernel_share(rec, ctx, key)``. Default None.
"""
