"""HDF5 ingest/output (numpy + lazy h5py) and synthetic observations."""
