"""Checkpoints in the reference's on-disk format (``checkpoint``) and the
replay stack's exact-resume layer over them (``replay_checkpoint``)."""
