"""AdamW, the LM substrate's optimizer."""
