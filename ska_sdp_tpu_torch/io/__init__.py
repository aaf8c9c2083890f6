"""HDF5 ingest/output (the ``h5`` façade over the native C++ backend and
the h5py backend) and synthetic observations."""
