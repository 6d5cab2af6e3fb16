"""The paper's bit-width synthesis on LM weights (port of `repro.quant`:
`qtypes`, `calibrate`, `range_lm`, `autoquant`)."""
