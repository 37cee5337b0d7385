from dynamo_tpu_torch.cli import main

main()
