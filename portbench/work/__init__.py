"""The yardstick's arithmetic: operations and bytes of each layer and unit
of work at its shapes (``counts``), and the card's peaks (``peaks``)."""
