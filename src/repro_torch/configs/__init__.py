"""Configs of the networks the port serves: the CNN graph builders
(VGG-19, LeNet-5, AlexNet) and the LM registry (`configs.base`, qwen3-0.6b)."""
