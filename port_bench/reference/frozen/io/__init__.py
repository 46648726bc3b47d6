"""HDF5 packet export."""
