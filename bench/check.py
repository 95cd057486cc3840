"""How ``correct`` is decided for a served cell.

Once the window has closed, the memory peak has been read and the engine is
freed, the plain reference (``bench/reference.py``) is run over a sample of
the requests the window finished (``serve.sample_requests``): each prompt,
worked out again from the prompt seed and the request id, followed by the
tokens the program served for it.  Three numbers are compared, each with
the limit the cell's file gives (``check.limits``; ``check.gap`` logits):

``first_over``  the share of the sampled requests whose first token (the
  one the prefill's last logits give) lies more than ``gap`` logits below
  the reference's best logit at its position: the prefill through every
  layer.
``tokens_over``  the same share of every served token of the sample: the
  paged decode and the tokens it feeds back.
``l0_rows_off``  the share of layer 0's (row, site) integer products, over
  one prefill call's prompt rows and one decode step's active slots that
  the window drove (picked by the seed), that differ from the reference's.
  At layer 0 both sides' inputs to each site are the same numbers but for
  the rounding of attention, so the tub kernel's exact product, the
  quantizer, RoPE, the prefill's attention and the fused paged decode are
  held to the rows on which a rounding difference flips a 4-bit code.

Deeper rows are not compared one by one, nor the widest gap of a token:
once the fused decode's rounding flips a code, the row moves by a whole
quantization step, and the two sides' later tokens part (PERF.md §2).
The control (``bench/control.py``, ``judge(control="tf32")``) puts the
reference, in TF32, in the program's place.
"""

from __future__ import annotations

import torch

from bench import reference as ref_lib

__all__ = ["judge", "reference_readings", "numbers", "gaps", "token_shares",
           "rows_off"]


def _sequences(window, chosen, prompt_seed: int, vocab: int, device):
    """(token tensor, served tokens tensor, prompt length) of each chosen
    request."""
    out = []
    for t_index, rid in chosen:
        tr = window.traces[t_index]
        spec = tr.by_id()[rid]
        served = tr.tokens[rid]
        prompt = ref_lib.prompt_tokens(prompt_seed, rid, spec.prompt_len, vocab)
        seq = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long,
                           device=device)
        out.append((seq, torch.tensor(served, dtype=torch.long, device=device),
                    spec.prompt_len))
    return out


def compared_rows(captured: dict, window, chosen) -> list:
    """``(sequence index, position, call, row of the call)`` of every row the
    layer check compares: the captured prefill's prompt rows and the active
    slots of the captured decode step."""
    where = {key: i for i, key in enumerate(chosen)}
    out = []
    c = captured["prefill"]
    p = window.traces[c["trace"]].by_id()[c["req_id"]].prompt_len
    i = where[(c["trace"], c["req_id"])]
    out += [(i, pos, "prefill", pos) for pos in range(p)]
    c = captured["decode"]
    slots = window.traces[c["trace"]].decode_slots()[c["step"]]
    lengths, active = c["lengths"].tolist(), c["active"].tolist()
    if sorted(s for s, _, _ in slots) != [i for i, a in enumerate(active) if a] \
            or any(lengths[slot] != pos for slot, _, pos in slots):
        raise RuntimeError("the engine's slots are not where the harness "
                           "placed them (lowest free slot at admission)")
    for slot, rid, pos in slots:
        out.append((where[(c["trace"], rid)], pos, "decode", slot))
    return out


def keep_of(rows: list) -> dict:
    """``{sequence index: sorted positions}`` the reference keeps."""
    keep: dict = {}
    for i, pos, _, _ in rows:
        keep.setdefault(i, set()).add(pos)
    return {i: torch.tensor(sorted(v)) for i, v in keep.items()}


def reference_readings(model: ref_lib.Reference, seqs, keep: dict,
                       layers=(0,)) -> tuple:
    """(logits at every served position, the kept rows' integer products at
    ``layers``) of ``model``."""
    rows = [torch.arange(p - 1, seq.shape[0], device=seq.device)
            for seq, _, p in seqs]
    keep = {i: v.to(seqs[0][0].device) for i, v in keep.items()}
    return model.run([seq for seq, _, _ in seqs], rows, keep, layers)


def gaps(ref_logits, served) -> torch.Tensor:
    """``max(ref) - ref[served]`` at every served position, one tensor."""
    return torch.cat([lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]
                      for lg, t in zip(ref_logits, served)])


def token_shares(ref_logits, served, gap: float) -> dict:
    """``first_over``: the share of the requests whose first token (the
    prefill's) lies more than ``gap`` logits below the reference's best;
    ``tokens_over``: the same share of every served token."""
    g = gaps(ref_logits, served)
    first = torch.stack([lg[0].max() - lg[0, t[0]]
                         for lg, t in zip(ref_logits, served)])
    return {"first_over": float((first > gap).float().mean()),
            "tokens_over": float((g > gap).float().mean())}


def rows_off(captured: dict, rows: list, keep: dict, ref: dict, layer: int = 0,
             other: dict | None = None) -> float:
    """The share of compared rows, over the sites of ``layer``, whose integer
    product differs from the reference's (``ref``: its products at that
    layer); ``other`` (another side's products, as ``ref``) stands in for
    the program's captured ones."""
    index = {i: {int(p): j for j, p in enumerate(v)} for i, v in keep.items()}
    off = total = 0
    for i, pos, call, r in rows:
        j = index[i][pos]
        for name in ref_lib.SITES:
            mine = (other[i][name][j] if other is not None
                    else captured[call]["sites"][(layer, name)][r])
            off += bool((mine.to(torch.float32) != ref[i][name][j]).any())
            total += 1
    return off / total


def numbers(values: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` in a fixed order."""
    return {k: {"value": values[k], "limit": limits[k]} for k in sorted(limits)}


def judge(cell: dict, sizes: dict, params: dict, window, captured: dict,
          chosen: list, prompt_seed: int,
          control: str | None = None) -> tuple[bool, dict]:
    """(correct, compared numbers) of a run.

    ``control``: a precision of the reference (``"tf32"``) that stands in
    for the program: at every position of the same sequences the token it
    puts first, and its layer-0 products, are judged in place of the
    program's (``bench/control.py``)."""
    device = params["embed"].device
    limits = cell["check"]["limits"]
    if "prefill" not in captured or "decode" not in captured:
        raise RuntimeError("the window ran too few steps to capture the "
                           "prefill and decode calls the check compares "
                           f"(captured: {sorted(captured)})")
    seqs = _sequences(window, chosen, prompt_seed, sizes["vocab_size"], device)
    bits = cell["engine"]["bits"]
    model = ref_lib.Reference(sizes, params, bits)
    rows = compared_rows(captured, window, chosen)
    keep = keep_of(rows)
    logits, products = reference_readings(model, seqs, keep)
    served, other = [s for _, s, _ in seqs], None
    if control is not None:
        stand_in = ref_lib.Reference(sizes, params, bits, precision=control)
        picked, other = reference_readings(stand_in, seqs, keep)
        served, other = [lg.argmax(dim=-1) for lg in picked], other[0]
    values = dict(token_shares(logits, served, cell["check"]["gap"]),
                  l0_rows_off=rows_off(captured, rows, keep, products[0],
                                       other=other))
    out = numbers(values, limits)
    correct = all(v["value"] <= v["limit"] for v in out.values())
    return correct, out
