"""The plain reference: the same imaging and prediction, written again in
plain PyTorch from the inputs alone.

It imports neither ``jax``, nor ``ska_sdp_tpu``, nor anything of
``ska_sdp_tpu_torch``, and takes nothing the program made: the weights,
the mirroring, the w-plane choice, the subgrid tiles and runs, the
A-screens and the tapers are all worked out here again.  A mix step names
its reference as ``<module>.<function>`` of this package
(``idg.image``); a new entry gets a module here.

Every function takes ``(req, cfg, device, rnd)``: ``req`` the request's
inputs as plain arrays (``uvw``, ``vis``, ``a1``, ``a2``, ``time``,
``freq``, and ``akerns``, ``model``, ``wkerns``, ``wbins`` where the step
has them), ``cfg`` the configuration's dict, and ``rnd`` the rounding
applied to the operands of every product: :func:`common.exact` for the
reference, :func:`common.tf32` for the control. Each returns a dict with
``image`` or ``vis`` and ``dropped``, and may give a ``region`` ``(lo,
hi)``: the rows and columns of the image that are compared. Products run
in float32 with TF32 off; the rounding is explicit, so the control reads
the same on any device.
"""
