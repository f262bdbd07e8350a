"""Assigned-architecture configs (one module per arch) + the paper's own
data-pipeline demo config.  Exact hyper-parameters from the assignment."""
