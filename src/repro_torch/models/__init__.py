"""The LM substrate for the dense GQA, MoE and MLA families — port of
`repro.models` (ROADMAP.md §A9 (i)–(iii)): parameter specs and seeded init
(`common`), the dense FFNs and the routed MoE FFN (`moe`), GQA attention
with causal prefill through the flash kernel on the card and multi-head
latent attention in torch ops (`attention`), the model (`transformer`),
the train / prefill / decode / greedy steps (`steps`), and the weight and
cache layouts between the two packages (`convert`)."""
