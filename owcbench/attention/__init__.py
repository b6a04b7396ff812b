"""How to read a flash attention call's shapes, one file per entry of the port.

A configuration lists, under ``program.attention``, the attention entries its
model calls (``module:function``). ``<function>.py`` here reads one call of
that entry: ``shape(args, kwargs)`` gives (batch, heads, kv heads, query
length, key length, head dim, causal, key mask or None, element size), what
``roofline.attention_bound`` takes. An entry the port adds is a new file.
"""
