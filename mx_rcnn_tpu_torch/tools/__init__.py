"""Operator tools run as modules: ``python -m mx_rcnn_tpu_torch.tools.soak``
(the serving soak: fleet, control loop and Deployer together) and
``python -m mx_rcnn_tpu_torch.tools.deploy_watch`` (a fleet with a Deployer
over a checkpoint directory); ``tools/loadgen.py`` holds the traffic shapes
they share."""
