"""The LM substrate for every family of `repro.configs` — port of
`repro.models` (ROADMAP.md §A9 (i)–(iv)): parameter specs, seeded init,
the sharding rule tables, RoPE and M-RoPE (`common`), the dense FFNs, the
routed MoE FFN and its sharding context (`moe`),
GQA attention with causal and bidirectional full attention through the
flash kernel on the card, multi-head latent attention and whisper's cross
attention in torch ops (`attention`), RWKV6 (`rwkv`) and Mamba (`mamba`)
blocks, the model with whisper's encoder (`transformer`), the train /
prefill / decode / greedy steps (`steps`), the weight and cache
layouts between the two packages (`convert`), and tensor parallelism on
local shards inside `local_map` (`parallel`)."""
