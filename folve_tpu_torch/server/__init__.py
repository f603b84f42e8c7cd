"""Frontends over the filesystem: the VFS operations, the status and
control page, and HTTP file serving."""
