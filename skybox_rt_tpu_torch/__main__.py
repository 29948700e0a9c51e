from .cli import main

# importing the module (as the tests import every module) runs nothing
if __name__ == "__main__":
    raise SystemExit(main())
