"""HDF5 ingest/output (the ``h5`` façade over the native C++ backend and
the h5py backend), the imaging inputs read through it (``inputs``) and
synthetic observations."""
