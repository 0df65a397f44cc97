"""Entry points of the port's language-model path: the prefill and decode
step builders (:mod:`.steps`) and the serving loop (:mod:`.serve`)."""
