"""Distribution of the port: logical-axis rules as DTensor placements
(``sharding``), the int8 compressed reduction (``collectives``) and the
elastic restore onto another mesh (``elastic``)."""
