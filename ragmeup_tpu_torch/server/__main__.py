from ragmeup_tpu_torch.server.app import main

if __name__ == "__main__":  # imported (a package walk), it starts nothing
    main()
