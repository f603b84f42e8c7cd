"""The FUSE transport: the native /dev/fuse session bridged to the VFS."""
