"""The LM substrate: five model families, prefill and cached decode."""
