"""Graph builders of the networks the port serves: VGG-19, LeNet-5, AlexNet."""
