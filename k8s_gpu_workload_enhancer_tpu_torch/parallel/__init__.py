"""The device mesh and the FSDP sharding of the param tree."""
