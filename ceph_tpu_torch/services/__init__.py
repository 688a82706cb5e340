"""Services on RADOS (the reference's L7): RBD-lite block images."""
