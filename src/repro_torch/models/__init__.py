"""The LM substrate for every family of `repro.configs` — port of
`repro.models` (ROADMAP.md §A9 (i)–(iii)): parameter specs, seeded init,
RoPE and M-RoPE (`common`), the dense FFNs and the routed MoE FFN (`moe`),
GQA attention with causal and bidirectional full attention through the
flash kernel on the card, multi-head latent attention and whisper's cross
attention in torch ops (`attention`), RWKV6 (`rwkv`) and Mamba (`mamba`)
blocks, the model with whisper's encoder (`transformer`), the train /
prefill / decode / greedy steps (`steps`), and the weight and cache
layouts between the two packages (`convert`)."""
