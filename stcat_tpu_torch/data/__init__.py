"""Host-side data path for serving: tokenizer, transform plan, raw batches."""
