"""The NetInvMgmt env and its topology compiler."""
