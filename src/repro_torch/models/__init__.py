"""The LM substrate's serving path for the dense GQA family — port of
`repro.models` (ROADMAP.md §A9 (i)): parameter specs and seeded init
(`common`), the dense FFNs (`moe`), GQA attention with causal prefill
through the flash kernel on the card (`attention`), the model
(`transformer`), the prefill / decode / greedy steps (`steps`), and the
weight and cache layouts between the two packages (`convert`)."""
