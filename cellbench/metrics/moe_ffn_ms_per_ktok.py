"""moe_ffn_ms_per_ktok (MoE FFN; ``.sat``): device milliseconds of the kernels
launched inside ``moe_forward`` (every layer) over the traced stretch, per
1000 tokens the stretch served (prompt tokens prefilled and tokens
decoded)."""


def read(run):
    tr, t = run.tracer, run.trace
    if tr is None or t is None:
        return None
    s = t.range_device_s.get("cb.moe_ffn", 0.0)
    tokens = tr.prefill_tokens + tr.decode_tokens
    if s <= 0 or not tokens:
        return None
    return s * 1e3 / (tokens / 1e3)
