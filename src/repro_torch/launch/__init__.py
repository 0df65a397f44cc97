"""Entry points of the port's language-model path: the train, prefill and
decode step builders (:mod:`.steps`), the training loop (:mod:`.train`)
and the serving loop (:mod:`.serve`)."""
