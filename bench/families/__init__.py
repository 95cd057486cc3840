"""Model families of the benchmark: one module a family, found by name.

A configuration file's ``"family"`` key names ``bench/families/<family>.py``
(absent: ``dense``), which the harness loads by file
(``manifest.family``), so a new family comes as a new file.  A family
module holds what is particular to its model and nothing of the serving
loop or the check:

``refuse_unserved(config, longest)``  raise ``manifest.ManifestError``
  where a published key asks for what the port's serve path or the
  family's reference do not implement (``longest``: the most positions a
  request of the cell holds, None for any);
``sizes_of(config, longest=None)``  the model sizes of the published keys,
  once ``refuse_unserved`` has passed them (a dict; ``vocab_size`` in it);
``port_config(name, sizes)``  the port's ``ModelConfig``;
``make_params(sizes, seed, device, rank=0, world=1)``  the weight tree of
  rank ``rank`` of ``world``, drawn on ``device`` from ``seed``: what the
  program and the reference are both handed;
``build(cell, sizes, seed, device, rank=0, world=1)``  ``(weights,
  engine)`` from the workload's ``engine`` options: a
  ``repro_torch.serving.engine.ServingEngine`` or an object with its
  attributes (``serve.PROGRAM_ATTRS``);
``token_ops(sizes, position)``, ``head_ops(sizes)``  the operations of a
  token through the layers at ``position`` and of the head once
  (``mfu.serve``);
``gemm_calls(sizes, engine, rows, head_rows, rank=0, world=1)``  the
  integer GEMMs one serve call of ``rows`` rows (``head_rows`` of them at
  the head) contracts on rank ``rank``: ``[(times, [(K, N, rows), ...])]``
  (``tub_gemm_roofline``);
``FAULTS`` (optional)  ``{name: context manager factory}``: faults of the
  family's timed path beyond ``bench/faults.py``'s, such as the exchange
  between cards left out, which ``bench/control.py --faults`` plants.

The configuration's ``"reference"`` key names the plain reference's file
(``manifest.reference``): ``SITES``, ``prompt_tokens(prompt_seed, req_id,
length, vocab)`` and ``Reference(sizes, params, bits, precision="fp32",
rank=0, world=1)`` with ``run(sequences, logit_rows, keep, layers)``, as
``bench/reference.py`` has them.
"""
