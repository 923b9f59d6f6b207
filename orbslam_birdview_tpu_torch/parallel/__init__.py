"""The multi-device layer: the mesh and its runtime (`runtime`), the
sharded global BA (`sharded_ba`), the sharded essential graph
(`sharded_pose_graph`) and the dry run (`dryrun`)."""
