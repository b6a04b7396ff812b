"""``flash_attention(q [B, H, Lq, D], k [B, KVH, Lk, D], v, *, causal, kv_mask)``."""


def shape(args, kw):
    q, k = args[0], args[1]
    b, h, lq, d = q.shape
    return b, h, k.shape[1], lq, k.shape[2], d, bool(kw.get("causal", False)), kw.get("kv_mask"), q.element_size()
