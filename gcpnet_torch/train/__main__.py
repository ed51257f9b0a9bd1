from gcpnet_torch.train.cli import main

main()
