"""CDF tables, Philox, and the NetInvMgmt episode kernels with their build."""
