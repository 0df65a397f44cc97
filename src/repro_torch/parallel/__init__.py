"""The port's parallel layer: logical-axis sharding rules resolved to
DTensor placements (:mod:`.sharding`) and the activation constraints the
model pins at its decision points (:mod:`.constraints`).  On one GPU no
mesh is registered and every constraint is the identity."""
