"""Entry points of the port: CNN serving (`serve_cnn`) and LM serving
(`serve`, over the step functions of `steps`)."""
