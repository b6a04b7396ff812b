"""Plain references of the benchmark's model families, one module each.

A configuration file names its family's module under ``"reference"``; the
harness loads ``reference/<name>.py`` by that name, so a new family is a new
file. A module gives, each taking the sizes ``a = arch(hf_config)`` and the
whole configuration ``cfg`` where it needs it:

- ``arch(hf_config)``: the sizes that count work;
- ``hf_layout(hf_config)``: every checkpoint tensor (name, shape, how it is drawn);
- ``checkpoint_dir(path, cfg)``: the checkpoint's files but its tensors;
- ``request_shape(a, cfg, request)``: what a request's work depends on, with
  its prompt's length under ``"prompt_tokens"``;
- ``count_work(a, cfg, work, shape, served)``: one answered request's operations;
- ``served_logits(a, cfg, state, precision, requests, device)``: the
  reference's logits at each served token.

The references import torch and numpy only: nothing of the port or of JAX.
"""
