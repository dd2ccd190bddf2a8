"""Host utilities of the port (the features.h5 reader and writer)."""
