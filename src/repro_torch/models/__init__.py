"""The dense transformer LM (port of `repro.models`: `common`,
`attention`, `blocks`, `lm`, `registry`)."""
