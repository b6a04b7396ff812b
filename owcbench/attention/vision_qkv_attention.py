"""``vision_qkv_attention(qkv [B, L, 3 * heads * D], num_heads, head_dim, *, kv_mask)``: no causal mask."""


def shape(args, kw):
    qkv, heads, d = args[0], args[1], args[2]
    return qkv.shape[0], heads, heads, qkv.shape[1], qkv.shape[1], d, False, kw.get("kv_mask"), qkv.element_size()
