"""Response logprobs objects (copy of ``gofr_tpu/openai/logprobs.py``): the
completions shape (token_logprobs / tokens / top_logprobs / text_offset)
and the chat ``content`` entries with the tokens' true bytes."""

from __future__ import annotations

from typing import Any


def logprobs_obj(
    tok: Any, lp_list: list, lp_ids: list, tops: Any, top_n: int, prompt_positions: int = 0,
) -> dict:
    """The choice-level logprobs object: ``token_logprobs``; ``tokens``
    aligned with it (single-token decodes, or the ids as strings without a
    tokenizer); ``text_offset``, each token's character start within the
    choice text (eval harnesses find the prompt/continuation boundary of an
    echo with it); and, when ``top_n`` > 0, per-position ``top_logprobs``
    maps of the N best alternatives (null at echoed prompt positions: the
    prompt is scored chosen-only)."""

    def key(t: int) -> str:
        return tok.decode([t]) if tok is not None else str(t)

    def alt_map(alts: list) -> dict:
        # distinct ids can decode to the same string; alts is best first,
        # so the first (best) value stays
        m: dict[str, float] = {}
        for i, v in alts[:top_n]:
            m.setdefault(key(i), v)
        return m

    # a host-matched stop cuts lp_list to the visible prefix while the ids
    # keep the whole generation (usage): tokens stay aligned with the values
    visible = lp_ids[: len(lp_list)]
    tokens = [key(t) for t in visible]
    # offsets come from the stream decoder, not per-token decodes: a
    # byte-level token can hold a fragment of a multi-byte character, and
    # only incremental decoding tiles the text the response carries
    offsets: list[int] = []
    pos = 0
    if tok is not None:
        dec = tok.stream_decoder()
        for t in visible:
            offsets.append(pos)
            pos += len(dec.feed(t))
    else:
        for t in tokens:
            offsets.append(pos)
            pos += len(t)
    obj: dict[str, Any] = {"token_logprobs": lp_list, "tokens": tokens, "text_offset": offsets}
    if top_n and tops is not None:
        obj["top_logprobs"] = [None] * prompt_positions + [alt_map(alts) for alts in tops]
    return obj


def chat_lp_entry(tok: Any, token_id: int, lp: float) -> dict:
    """One {token, logprob, bytes} content entry; ``bytes`` holds the
    token's true bytes (a fragment of a multi-byte character survives, so
    clients can reassemble text across such splits)."""
    raw = tok.decode_bytes([token_id])
    return {"token": raw.decode("utf-8", errors="replace"), "logprob": lp, "bytes": list(raw)}


def chat_logprobs_obj(tok: Any, lp_list: list, out_ids: list, tops: Any, top_n: int) -> dict:
    """Chat logprobs in the current OpenAI chat shape, a ``content`` list
    of {token, logprob, bytes, top_logprobs} entries (``top_logprobs`` is
    always present, [] without alternatives), beside the completions-style
    fields the JAX package also sends."""
    obj = logprobs_obj(tok, lp_list, out_ids, tops, top_n)
    content = []
    for j, (t, lp) in enumerate(zip(out_ids[: len(lp_list)], lp_list)):
        e = chat_lp_entry(tok, t, lp)
        e["top_logprobs"] = (
            [chat_lp_entry(tok, i, v) for i, v in tops[j][:top_n]]
            if top_n and tops is not None else []
        )
        content.append(e)
    obj["content"] = content
    return obj
