"""Examples of the port, run as modules (python -m gan_sass_tf_tpu_torch.examples.quickstart)."""
