"""The port's optimizer: AdamW (:mod:`.adamw`), the warmup-cosine schedule
(:mod:`.schedule`) and int8 gradient compression with error feedback
(:mod:`.grad_compress`)."""
