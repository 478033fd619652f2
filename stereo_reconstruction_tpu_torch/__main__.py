from stereo_reconstruction_tpu_torch.cli import main

main()
