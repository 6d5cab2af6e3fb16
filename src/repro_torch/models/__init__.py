"""The transformer LM, dense and MoE (port of `repro.models`: `common`,
`attention`, `moe`, `blocks`, `lm`, `registry`)."""
