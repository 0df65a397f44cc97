"""Entry points of the port's language-model path: the train, prefill and
decode step builders and their abstract inputs (:mod:`.steps`), the
training loop (:mod:`.train`), the serving loop (:mod:`.serve`), and the
planning tools for H100 clusters: the meshes (:mod:`.mesh`), the dry run
(:mod:`.dryrun`), its graph analysis (:mod:`.graphanalysis`), the
roofline (:mod:`.roofline`) and the hill-climb (:mod:`.hillclimb`)."""
