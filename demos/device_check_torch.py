"""Device availability check (the port of ``demos/device_check.py``, the
reference's ``test.py:1-4``): the backend, the devices and their count as
``torch.cuda`` sees them.

    python demos/device_check_torch.py
"""

import torch


def main():
    cuda = torch.cuda.is_available()
    count = torch.cuda.device_count() if cuda else 0
    print("backend:", "cuda" if cuda else "cpu")
    print("devices:", [torch.cuda.get_device_name(i) for i in range(count)] if cuda
          else ["cpu"])
    print("device count:", count if cuda else 1)


if __name__ == "__main__":
    main()
