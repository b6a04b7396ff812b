"""``fused_qkv_attention(qkvh, num_q_heads, num_kv_heads, *, causal, kv_mask, token_major)``:
qkvh is [B, heads, L, D], or [B, L, heads, D] with ``token_major``."""


def shape(args, kw):
    qkvh, nq, nkv = args[0], args[1], args[2]
    length = qkvh.shape[1] if kw.get("token_major") else qkvh.shape[2]
    return (qkvh.shape[0], nq, nkv, length, length, qkvh.shape[-1], bool(kw.get("causal", False)),
            kw.get("kv_mask"), qkvh.element_size())
